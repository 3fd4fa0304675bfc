"""Stage 2 — unpaired HQ <-> LQ depth translation, CycleGAN-style (counterpart
of ``desr_tpu/models/translation_model.py``): the serving forward and training.

``G_A`` (synthetic/HQ -> real/LQ) and ``G_B`` (real/LQ -> synthetic/HQ) are
the translators of ``translation_networks.define_Gen`` (``G_B`` takes depth
alone under --inp_B depth); their ResnetBlockT bottlenecks run on K1, forward
and backward. Four PatchGAN discriminators judge depth and FOV surface
normals per direction (:119-128). ``optimize_parameters`` alternates
--num_iter_gen G steps with --num_iter_dis D steps (:512-543):

- a G step trains G_A and G_B alone (Adam, (--beta1, 0.999), L2 decay
  --w_decay_G); the Ds stay in train mode without gradients, so a BatchNorm
  in them (--netD Gu, --norm_d batch) normalises with the batch's moments and
  moves its running statistics in the G step too (:365-369);
- the first D step trains on the last G step's detached tensors, made with
  the generators' weights from before that step's update (:525-543); a later
  one runs a fresh generator forward without gradients;
- a D is applied once to concat(real, fake) only where it holds no per-apply
  state (``d_stateless``, :276-286), else to each apart.

As shipped (the JAX module docstring, :1-26): D_A trains against
``rec_depth_B`` / ``rec_norm_B`` as "real" (:311-321); ``--no_idt_A`` is a
store_true flag defaulting to True, so ``idt_A`` feeds no loss and is not
computed here; the masked cos-sim cycle_n_A divides by sum(mask) + 1e6; the
weight ramps (``calc_l_step``, ``update_loss_weight``) are hooks that the
trainer does not call, as in main.py. --fused_iter, one XLA program per
iteration in the JAX package with the same trajectory, runs this same loop.

Under ``--spatial_devices`` (``BaseModel.step_layout``) every step runs on
this rank's band of each frame's rows: the translators' convs, pads,
transposed convs and GroupNorms read halo rows and the frame's moments, and
their K1 blocks take halo rows forward and backward; the FOV normals take
the band's rows of the camera grid and one halo row each side. The
PatchGAN and Gu Ds gather before their whole levels, so every rank holds
their whole logits; the pixel D returns the band's. Each term follows the
losses' convention over the step's group (``ops/losses.py``): the masked
L1 and cos-sim terms divide by the global mask count (``group``); the
means (``l1_loss``, ``cos_sim_loss_planar``, ``gan_loss`` on banded
logits) are over equal bands; ``gan_loss`` on whole logits is a mean that
every rank of a data group computes alike; ``tv_norm_planar`` counts a
seam once. The metrics are the global batch's (``global_metrics``), the
visuals whole frames (``whole_frames``).
"""

from __future__ import annotations

import numpy as np
import torch

from desr_tpu_torch.models import translation_networks as TN
from desr_tpu_torch.models.base_model import BaseModel
from desr_tpu_torch.models.main_model import NetOptions, _to_device
from desr_tpu_torch.ops import losses as L
from desr_tpu_torch.ops.normals import surface_normals_fov_planar
from desr_tpu_torch.parallel.mesh import Shard
from desr_tpu_torch.utils.util import to_numpy

HOLE_BORDER = -0.98  # translation_model.py:42
INPUT_KEYS = ("A_depth", "A_img", "B_depth", "B_img")



class TranslationModel(BaseModel):
    """The two translators on one device, and with ``is_train`` the four
    discriminators (those of --disc_for_depth and --disc_for_normals).

    ``opt``: ``NetOptions`` (``init_type``, ``inp_B``) for serving, or the
    parsed train options with ``is_train=True``. ``direction``: "AtoB" or
    "BtoA", the generator ``serve_forward`` applies. Parameters are float32;
    the nets run in ``compute_dtype`` with float32 normals and losses.
    ``generator`` seeds the initial weights (G_A, G_B, then the Ds).
    ``mesh``: this rank's data mesh (``BaseModel``); each G and D step
    averages its gradients over the ranks before its Adam step.
    """

    model_names = ("G_A", "G_B")
    trainable_nets = ("G_A", "G_B")
    _multi_step = False  # one iteration a call, as in the JAX trainer

    def __init__(self, opt=None, device=None, compute_dtype=torch.bfloat16, generator=None,
                 direction="AtoB", is_train=False, mesh=None):
        opt = opt or NetOptions()
        if direction not in ("AtoB", "BtoA"):
            raise ValueError(f"direction {direction!r}: AtoB or BtoA")
        if is_train and (opt.l_mean_A > 0 or opt.l_mean_B > 0):
            # the JAX model hands masked_mean_dif (losses.py:38, which sums
            # over NHWC axes 1-3) planar (B, H, W) maps (:255-262) and stops
            raise NotImplementedError(
                "--l_mean_A / --l_mean_B > 0: the JAX package's mean-difference term fails "
                "on the stage's planar depth maps; not ported")
        super().__init__(opt, device, compute_dtype, mesh)
        if generator is None:
            generator = torch.Generator().manual_seed(getattr(opt, "seed", 0))
        gen_opt = TN.default_translator_opt(init_type=opt.init_type)
        nets = {"G_A": TN.define_Gen(gen_opt, "img_depth", generator=generator),
                "G_B": TN.define_Gen(gen_opt, opt.inp_B, generator=generator)}
        self.depth_only_B = opt.inp_B == "depth"
        self.direction = direction
        self.is_train = is_train
        # translation_model.py:108-113
        self.visual_names = ("real_img_A", "real_depth_A", "real_img_B", "real_depth_B",
                             "fake_depth_B", "fake_depth_A") \
            + (("rec_depth_A",) if getattr(opt, "use_cycle_A", False) else ()) \
            + (("rec_depth_B",) if getattr(opt, "use_cycle_B", False) else ())
        self.disc_names = ()
        if is_train:
            if opt.disc_for_depth:
                self.disc_names += ("D_A_depth", "D_B_depth")
            if opt.disc_for_normals:
                self.disc_names += ("D_A_normal", "D_B_normal")
            for dn in self.disc_names:
                nets[dn] = TN.define_D(opt, "depth" if dn.endswith("depth") else "normal",
                                       generator=generator)
            self.model_names = self.model_names + self.disc_names
        self.nets = torch.nn.ModuleDict(nets)
        self.to(self.device)
        self.requires_grad_(False)
        self._batch = None
        if not is_train:
            self.eval()
            return
        self.train()  # the Ds' BatchNorm runs on batch moments; nothing else has a mode
        self.apply_remat()
        self.loss_names = self._loss_names(opt)
        self.split_trainable(betas=(opt.beta1, 0.999), weight_decay=opt.w_decay_G)
        if self.disc_names:
            self.optimizer_D = self.add_optimizer(self.disc_names, (opt.beta1, 0.999))
            for dn in self.disc_names:  # given gradients only in d_grads
                self.nets[dn].requires_grad_(False)
        # ramped loss weights (translation_model.py:130-136)
        self.l_depth_A, self.l_depth_B = opt.l_depth_A_begin, opt.l_depth_B_begin
        self.l_cycle_A, self.l_cycle_B = opt.l_cycle_A_begin, opt.l_cycle_B_begin
        self.calc_l_step()

    @staticmethod
    def _loss_names(opt):
        """translation_model.py:86-106 (less mean_dif_A/B: --l_mean_A/B > 0 is refused)."""
        names = ["G_A", "G_B", "depth_dif_A", "depth_dif_B"]
        for flag, keys in ((opt.use_cycle_A, ["cycle_A", "cycle_n_A"]),
                           (opt.use_cycle_B, ["cycle_B", "cycle_n_B"]),
                           (opt.disc_for_depth, ["D_A_depth", "D_B_depth"]),
                           (opt.disc_for_normals, ["D_A_normal", "D_B_normal"]),
                           (opt.l_identity > 0, ["idt_A", "idt_B"]),
                           (opt.l_depth_A_begin > 0, ["depth_range_A"]),
                           (opt.l_depth_B_begin > 0, ["depth_range_B"]),
                           (opt.l_tv_A > 0, ["tv_norm_A"])):
            if flag:
                names += keys
        return names

    def pretrained_nets(self):
        """None: a new stage-2 run starts every net from its init."""
        return []

    # -- weight ramps (translation_model.py:140-152) -------------------------

    def calc_l_step(self):
        opt = self.opt
        self.l_depth_A_step = abs(opt.l_depth_A_begin - opt.l_depth_A_end) / opt.l_num_iter
        self.l_depth_B_step = abs(opt.l_depth_B_begin - opt.l_depth_B_end) / opt.l_num_iter
        self.l_cycle_A_step = abs(opt.l_cycle_A_begin - opt.l_cycle_A_end) / opt.l_num_iter
        self.l_cycle_B_step = abs(opt.l_cycle_B_begin - opt.l_cycle_B_end) / opt.l_num_iter

    def update_loss_weight(self, global_iter):
        if global_iter > self.opt.l_max_iter:
            self.l_depth_A -= self.l_depth_A_step
            self.l_depth_B -= self.l_depth_B_step
            self.l_cycle_A += self.l_cycle_A_step
            self.l_cycle_B += self.l_cycle_B_step

    # -- forward ---------------------------------------------------------------

    def _apply_G(self, name, depth_bhw, img):
        """One translator on (B, H, W) float32 depth and NCHW image (None for
        a depth-only G_B), in the compute dtype; (B, H, W) float32."""
        x = depth_bhw[:, None].to(self.compute_dtype)
        if name == "G_B" and self.depth_only_B:
            img = None
        return self.nets[name](x, img)[:, 0].float()

    @torch.no_grad()
    def serve_forward(self, batch):
        """The translated depth (B, H, W) float32 of "B_d" (B, H, W, 1) and
        "B_i" (B, H, W, 3), both in [-1, 1], numpy arrays or tensors:
        ``fake_depth_B`` = G_A(depth, image) under AtoB, ``fake_depth_A`` =
        G_B(depth, image) (G_B(depth) under --inp_B depth) under BtoA
        (translation_model.py:172-177); on a mesh of several ranks this
        rank's rows, as ``MainModel.serve_forward``'s."""
        batch = self.shard(batch)
        depth = _to_device(batch["B_d"], self.device).float()[..., 0]
        image = _to_device(batch["B_i"], self.device).to(self.compute_dtype).permute(0, 3, 1, 2)
        with self.serving_layout(batch, self.nets):
            return self._apply_G("G_A" if self.direction == "AtoB" else "G_B", depth, image)

    def gen_forward(self, batch, idt=True):
        """The generator forward of translation_model.py:162-200: planar
        (B, H, W) depth maps, (B, 3, H, W) normals, all float32. Runs G_A(A),
        G_B(B), the cycles (G_B(fake_B) under --use_cycle_A, G_A(fake_A)
        under --use_cycle_B) and, with ``idt`` and --l_identity > 0, the
        identity G_B(A) (and G_A(B) were --no_idt_A off)."""
        opt = self.opt
        dA, dB = batch["A_depth"][..., 0], batch["B_depth"][..., 0]
        img_A = batch["A_img"].to(self.compute_dtype).permute(0, 3, 1, 2)
        img_B = batch["B_img"].to(self.compute_dtype).permute(0, 3, 1, 2)
        f = {"real_depth_A": dA, "real_depth_B": dB, "hole_mask_A": dA <= HOLE_BORDER,
             "real_img_A": batch["A_img"], "real_img_B": batch["B_img"]}
        f["fake_depth_B"] = self._apply_G("G_A", dA, img_A)
        f["fake_depth_A"] = self._apply_G("G_B", dB, img_B)
        f["hole_mask_B"] = f["fake_depth_A"] <= HOLE_BORDER
        for k in ("real_depth_A", "real_depth_B", "fake_depth_A", "fake_depth_B"):
            f[k.replace("depth", "norm")] = self._normals(f[k])
        if opt.use_cycle_A:
            f["rec_depth_A"] = self._apply_G("G_B", f["fake_depth_B"], img_A)
            f["rec_norm_A"] = self._normals(f["rec_depth_A"])
        if opt.use_cycle_B:
            f["rec_depth_B"] = self._apply_G("G_A", f["fake_depth_A"], img_B)
            f["rec_norm_B"] = self._normals(f["rec_depth_B"])
        if idt and opt.l_identity > 0:
            if not opt.no_idt_A:
                f["idt_A"] = self._apply_G("G_A", dB, img_B)
            f["idt_B"] = self._apply_G("G_B", dA, img_A)
        return f

    def _normals(self, depth):
        """The FOV normals of a planar depth map (the rank's band of it
        under ``spatial``)."""
        return surface_normals_fov_planar(depth, spatial=self.spatial)

    def _d_logits(self, name, x):
        """A discriminator on a planar depth (B, H, W) or normal map
        (B, 3, H, W), float32 logits."""
        if x.dim() == 3:
            x = x[:, None]
        return self.nets[name](x.to(self.compute_dtype)).float()

    def d_stateless(self):
        """True when the Ds hold no per-apply state, so that one apply to
        concat(real, fake) equals two (translation_model.py:276-286): not
        under BatchNorm (--netD Gu, --norm_d batch) or spectral norm, nor
        with --no_batched_branches."""
        opt = self.opt
        return (opt.netD != "Gu" and opt.norm_d != "batch" and not opt.use_spnorm
                and not opt.no_batched_branches)

    # -- losses ----------------------------------------------------------------

    def _meters(self, x):
        md = self.opt.max_distance
        return (x * (md / 2) + md / 2) / 1000.0

    def depth_difs(self, f):
        """depth_dif_A / depth_dif_B: masked L1 in meters (:381-384)."""
        return {"depth_dif_A": L.masked_l1_loss(self._meters(f["real_depth_A"]),
                                                self._meters(f["fake_depth_B"]),
                                                ~f["hole_mask_A"], group=self.step_group),
                "depth_dif_B": L.masked_l1_loss(self._meters(f["real_depth_B"]),
                                                self._meters(f["fake_depth_A"]),
                                                ~f["hole_mask_B"], group=self.step_group)}

    def g_losses(self, f):
        """(loss_G, terms) of translation_model.py:220-272 (the refused
        mean-difference terms aside)."""
        opt, mode = self.opt, self.opt.gan_mode
        m = {}
        loss_A = loss_B = 0.0
        if opt.disc_for_depth:
            loss_A += 0.5 * L.gan_loss(self._d_logits("D_A_depth", f["fake_depth_B"]), True, mode)
            loss_B += 0.5 * L.gan_loss(self._d_logits("D_B_depth", f["fake_depth_A"]), True, mode)
        if opt.disc_for_normals:
            loss_A += 0.5 * L.gan_loss(self._d_logits("D_A_normal", f["fake_norm_B"]), True, mode)
            loss_B += 0.5 * L.gan_loss(self._d_logits("D_B_normal", f["fake_norm_A"]), True, mode)
        m["G_A"], m["G_B"] = loss_A, loss_B
        l_cycle_A, l_cycle_B = self.l_cycle_A, self.l_cycle_B
        if opt.use_cycle_A:
            not_hole = ~f["hole_mask_A"]
            m["cycle_A"] = L.masked_l1_loss(f["rec_depth_A"], f["real_depth_A"],
                                            not_hole, group=self.step_group) * l_cycle_A
            m["cycle_n_A"] = L.masked_cos_sim_loss_planar(
                f["rec_norm_A"], f["real_norm_A"], not_hole[:, None].expand(-1, 3, -1, -1),
                group=self.step_group) * opt.l_normal * l_cycle_A
            loss_A = loss_A + m["cycle_A"] + m["cycle_n_A"]
        if opt.use_cycle_B:
            m["cycle_B"] = L.l1_loss(f["rec_depth_B"], f["real_depth_B"]) * l_cycle_B
            m["cycle_n_B"] = L.cos_sim_loss_planar(f["rec_norm_B"], f["real_norm_B"]) \
                * opt.l_normal * l_cycle_B
            loss_B = loss_B + m["cycle_B"] + m["cycle_n_B"]
        if opt.l_identity > 0:
            m["idt_A"] = torch.zeros((), device=self.device)
            if not opt.no_idt_A:
                m["idt_A"] = L.l1_loss(f["idt_A"], f["real_depth_B"]) * opt.l_identity
                loss_A = loss_A + m["idt_A"]
            m["idt_B"] = L.l1_loss(f["idt_B"], f["real_depth_A"]) * opt.l_identity
            loss_B = loss_B + m["idt_B"]
        if opt.l_tv_A > 0:
            m["tv_norm_A"] = L.tv_norm_planar(f["fake_norm_B"], self.spatial) * opt.l_tv_A
            loss_A = loss_A + m["tv_norm_A"]
        m["depth_range_A"] = L.masked_l1_loss(f["fake_depth_B"], f["real_depth_A"],
                                              ~f["hole_mask_A"], group=self.step_group) \
            * max(self.l_depth_A, 0.0)
        m["depth_range_B"] = L.masked_l1_loss(f["fake_depth_A"], f["real_depth_B"],
                                              ~f["hole_mask_B"], group=self.step_group) \
            * max(self.l_depth_B, 0.0)
        return loss_A + m["depth_range_A"] + loss_B + m["depth_range_B"], m

    def _d_pair(self, name, real, fake):
        """0.5 (GAN(D(real), 1) + GAN(D(fake), 0)) (:294-305)."""
        mode = self.opt.gan_mode
        if self.d_stateless():
            pred = self._d_logits(name, torch.cat([real, fake], 0))
            pr, pf = pred[:real.shape[0]], pred[real.shape[0]:]
        else:
            pr, pf = self._d_logits(name, real), self._d_logits(name, fake)
        return 0.5 * (L.gan_loss(pr, True, mode) + L.gan_loss(pf, False, mode))

    def d_losses(self, f):
        """(loss_D, terms) of translation_model.py:307-325: D_A against
        rec_depth_B / rec_norm_B as "real" under --use_cycle_B."""
        opt, m = self.opt, {}
        rec = "rec" if opt.use_cycle_B else "real"
        if opt.disc_for_depth:
            m["D_A_depth"] = self._d_pair("D_A_depth", f[f"{rec}_depth_B"], f["fake_depth_B"])
            m["D_B_depth"] = self._d_pair("D_B_depth", f["real_depth_A"], f["fake_depth_A"])
        if opt.disc_for_normals:
            m["D_A_normal"] = self._d_pair("D_A_normal", f[f"{rec}_norm_B"], f["fake_norm_B"])
            m["D_B_normal"] = self._d_pair("D_B_normal", f["real_norm_A"], f["fake_norm_A"])
        return sum(m.values()), m

    def d_feed_keys(self):
        """The forward tensors the D step reads (:329-341)."""
        rec = "rec" if self.opt.use_cycle_B else "real"
        keys = []
        for kind, flag in (("depth", self.opt.disc_for_depth), ("norm", self.opt.disc_for_normals)):
            if flag:
                keys += [f"fake_{kind}_B", f"fake_{kind}_A", f"real_{kind}_A", f"{rec}_{kind}_B"]
        return keys

    # -- steps -----------------------------------------------------------------

    def stage(self, batch):
        """(device tensors, no paths) of this rank's rows of a host batch
        (A_depth, A_img, B_depth, B_img)."""
        batch = self.shard(batch)
        return Shard({k: _to_device(batch[k], self.device).float() for k in INPUT_KEYS},
                     batch.rows, batch.h_rows), {}

    def compute_grads(self, batch=None):
        """The G step's forward, losses and backward (:354-371), gradients
        (averaged over the ranks) left on G_A and G_B. Returns (this rank's
        terms and depth_difs, detached; the D step's feed, detached)."""
        batch = self._batch if batch is None else batch
        self.optimizer.zero_grad(set_to_none=True)
        with self.step_layout(batch):
            f = self.gen_forward(batch)
            loss, m = self.g_losses(f)
            loss.backward()
            with torch.no_grad():
                m.update(self.depth_difs(f))
        self.reduce_grads(self.trainable_nets)
        return ({k: v.detach() for k, v in m.items()},
                {k: f[k].detach() for k in self.d_feed_keys()})

    def d_grads(self, f):
        """The D step's losses and backward on the forward tensors ``f``,
        gradients (averaged over the ranks) left on the Ds. Returns this
        rank's terms, detached."""
        for dn in self.disc_names:
            self.nets[dn].requires_grad_(True)
        try:
            self.optimizer_D.zero_grad(set_to_none=True)
            with self.step_layout(self._batch):
                total, m = self.d_losses(f)
                total.backward()
            self.reduce_grads(self.disc_names)
        finally:
            for dn in self.disc_names:
                self.nets[dn].requires_grad_(False)
        return {k: v.detach() for k, v in m.items()}

    def optimize_parameters(self, iters=0, fr=1):
        """One training iteration (:512-543): --num_iter_gen G steps, then
        --num_iter_dis D steps, the first on the last G step's tensors."""
        feed = None
        for _ in range(self.opt.num_iter_gen):
            self.metrics, feed = self.compute_grads()
            self.optimizer.step()
        for j in range(self.opt.num_iter_dis if self.disc_names else 0):
            if j > 0 or feed is None:
                with torch.no_grad(), self.step_layout(self._batch):
                    feed = self.gen_forward(self._batch, idt=False)
            self.metrics.update(self.d_grads(feed))
            self.optimizer_D.step()
        self.metrics = self.global_metrics(self.metrics)

    @torch.no_grad()
    def calculate(self, stage="test"):
        """The eval forward (:424-433, :545-548): depth_dif_A/B in meters,
        and the visuals of ``visual_names`` (NHWC images, planar depths)."""
        with self.step_layout(self._batch):
            f = self.gen_forward(self._batch, idt=False)
            self.metrics = self.global_metrics(self.depth_difs(f))
        self.visuals = self.whole_frames({k: f[k] for k in self.visual_names if k in f})

    def calc_test_loss(self):
        self.calculate()
        self.test_depth_dif_A = float(self.metrics["depth_dif_A"])
        self.test_depth_dif_B = float(self.metrics["depth_dif_B"])

    # -- the metric API on the last calculate's visuals (:550-602) -------------

    def _masked_l1_m(self, a, b, mask):
        mask = to_numpy(mask)
        return float(np.sum(np.abs(to_numpy(self._meters(b)) - to_numpy(self._meters(a))) * mask)
                     / (mask.sum() + 1e-6))

    def get_L1_loss(self):
        f = self.visuals
        return self._masked_l1_m(f["real_depth_A"], f["fake_depth_B"],
                                 f["real_depth_A"] > HOLE_BORDER)

    def get_L1_loss_syn(self):
        f = self.visuals
        return self._masked_l1_m(f["real_depth_B"], f["fake_depth_A"],
                                 f["fake_depth_A"] > HOLE_BORDER)

    def get_L1_loss_cycle(self):
        f = self.visuals
        return self._masked_l1_m(f["real_depth_A"], f["rec_depth_A"],
                                 f["real_depth_A"] > HOLE_BORDER)

    def get_L1_loss_cycle_syn(self):
        f = self.visuals
        return float(np.mean(np.abs(to_numpy(self._meters(f["rec_depth_B"]))
                                    - to_numpy(self._meters(f["real_depth_B"])))))

    def get_dif(self):
        """Signed masked mean difference in meters, fake_B - real_A."""
        f = self.visuals
        mask = to_numpy(f["real_depth_A"] > HOLE_BORDER)
        return float(np.sum((to_numpy(self._meters(f["fake_depth_B"]))
                             - to_numpy(self._meters(f["real_depth_A"]))) * mask)
                     / (mask.sum() + 1e-6))

    def get_dif_syn(self):
        f = self.visuals
        mask = to_numpy(f["fake_depth_A"] > HOLE_BORDER)
        return float(np.sum((to_numpy(self._meters(f["fake_depth_A"]))
                             - to_numpy(self._meters(f["real_depth_B"]))) * mask)
                     / (mask.sum() + 1e-6))

    def get_mask(self, depth):
        return to_numpy(depth) <= HOLE_BORDER
