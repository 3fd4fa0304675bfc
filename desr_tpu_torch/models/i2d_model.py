"""Stage 1 — the image guidance network (counterpart of
``desr_tpu/models/i2d_model.py``): depth from RGB alone.

``Image_f`` (a ResNet generator, whose ResnetBlocks run on K1) turns the image
into features and ``Task`` (a U-Net) regresses depth from them; stage 3 runs
both frozen as ``I2D_features`` and ``Image2Depth``. Trained with a masked L1
(mask ``depth > -0.97``) on both domains (i2d_model.py:117-138). As shipped:

- the generator's Adam, (0.9, 0.999), covers ``Task`` only (:74-75, :178-179):
  ``Image_f`` keeps its weights unless ``--i2d_train_features``;
- ``--norm_loss`` reports the normals' L1 and does not add it to the loss;
- ``--use_D``: a discriminator ``D_depth`` on the features, with a replay pool
  and the throttled update schedule of :245-258. Its adversarial term
  GAN(D(features_real), True), through a frozen D, joins G's loss only when
  ``Image_f`` trains (:141-176): for ``Task`` its gradient is zero.

Under ``--spatial_devices`` the step runs on this rank's band of each
frame's rows (``BaseModel.step_layout``); ``D_depth``'s PatchGAN gathers
before its stride-1 tail, and the replay pool, which holds whole frames,
is queried with the features gathered along B and H on every rank.
"""

from __future__ import annotations

import random

import torch

from desr_tpu_torch.models import networks
from desr_tpu_torch.models.base_model import BaseModel
from desr_tpu_torch.models.layers import batch_norm_mode
from desr_tpu_torch.models.main_model import NetOptions, _to_device
from desr_tpu_torch.ops import losses as L
from desr_tpu_torch.ops import normals as NRM
from desr_tpu_torch.parallel import spatial as S
from desr_tpu_torch.parallel.mesh import Shard, all_gather_rows
from desr_tpu_torch.utils.image_pool import ImagePool

BORDER = -0.97  # i2d_model.py:122-123
INPUT_KEYS = ("A_i", "B_i", "A_d", "B_d")


class I2DModel(BaseModel):
    """I2DModel (i2d_model.py) on one device.

    ``opt``: ``NetOptions`` for serving, or the parsed train options with
    ``is_train=True`` (then ``D_depth`` too under ``--use_D``). Parameters are
    float32; the nets run in ``compute_dtype`` with float32 losses.
    ``generator`` seeds the initial weights; the replay pool draws its swaps
    from a ``random.Random`` seeded with ``--seed``. ``mesh``: this rank's
    data mesh (``BaseModel``); over split batches every rank queries an
    identical pool with the global batch's features and keeps its rows.
    """

    model_names = ("Image_f", "Task")
    visual_names = ("syn_image", "syn_depth", "pred_syn_depth",
                    "real_image", "real_depth", "pred_real_depth")  # i2d_model.py:55

    def __init__(self, opt=None, device=None, compute_dtype=torch.bfloat16, generator=None,
                 is_train=False, mesh=None):
        opt = opt or NetOptions()
        super().__init__(opt, device, compute_dtype, mesh)
        self.is_train = is_train
        self.use_D = is_train and opt.use_D
        if generator is None:
            generator = torch.Generator().manual_seed(getattr(opt, "seed", 0))
        common = dict(norm=opt.norm, use_dropout=False, init_type=opt.init_type,
                      init_gain=opt.init_gain, replace_transpose=opt.replace_transpose,
                      generator=generator, fused=not opt.pallas_conv)
        nets = {
            "Image_f": networks.define_G(3, opt.Imagef_outf, opt.Imagef_basef, opt.Imagef_type,
                                         n_down=opt.Imagef_ndown, **common),
            "Task": networks.define_G(opt.Imagef_outf, 1, opt.Task_basef, opt.Task_type,
                                      n_down=opt.Task_ndown, **common),
        }
        if self.use_D:
            self.model_names = self.model_names + ("D_depth",)
            nets["D_depth"] = networks.define_D(opt.Imagef_outf, opt.ndf, opt.netD,
                                                opt.n_layers_D, opt.norm, opt.init_type,
                                                opt.init_gain, generator=generator)
        self.nets = torch.nn.ModuleDict(nets)
        self.to(self.device)
        self.eval()  # a BatchNorm (--norm batch) takes its mode from batch_norm_mode
        self.requires_grad_(False)
        # the JAX scan covers the G-only configuration (i2d_model.py:190-194)
        self._multi_step = not self.use_D
        if is_train:
            self.apply_remat()
            self.loss_names = ["task_syn", "task_real"]
            if opt.norm_loss:
                self.loss_names += ["syn_norms"]
            if self.use_D:
                self.loss_names += ["G_pred", "D_depth", "G_pred_r"]
            self.trainable_nets = ("Task",) + (("Image_f",) if opt.i2d_train_features else ())
            self.split_trainable(betas=(0.9, 0.999))
            if self.use_D:
                self.optimizer_D = self.add_optimizer(["D_depth"], (opt.beta1, 0.999))
                self.nets["D_depth"].requires_grad_(False)  # trained only in d_step
                self.fake_depth_pool = ImagePool(opt.pool_size,
                                                 random.Random(getattr(opt, "seed", 0)))
        self._batch = None
        self._paths = {}

    def pretrained_nets(self):
        """None: a new stage-1 run starts every net from its init, ``Image_f``
        too, though it does not train by default (base_model.py:106-116)."""
        return []

    # ------------------------------------------------------------------

    @torch.no_grad()
    def serve_forward(self, batch):
        """``pred_real_depth`` (B, H, W) float32 of the real branch: ``Task``
        on ``Image_f``'s features of "B_i" (B, H, W, 3) in [-1, 1], a numpy
        array or tensor; on a mesh of several ranks this rank's rows, as
        ``MainModel.serve_forward``'s."""
        batch = self.shard(batch)
        image = _to_device(batch["B_i"], self.device).to(self.compute_dtype).permute(0, 3, 1, 2)
        with self.serving_layout(batch, self.nets):
            return self.nets["Task"](self.nets["Image_f"](image))[:, 0].float()

    def forward_all(self, batch, train=True):
        """(feats_syn, feats_real, pred_syn, pred_real): compute-dtype NCHW
        features, float32 (B, H, W) predictions (i2d_model.py:79-110). Both
        branches share one batch-2B call of each net unless
        ``--no_batched_branches``. A BatchNorm (--norm batch) normalises with
        the batch's moments when ``train`` and its running statistics
        otherwise, and moves neither (no stats sink, as in JAX)."""
        with batch_norm_mode(train):
            return self._forward_all(batch)

    def _forward_all(self, batch):
        dt = self.compute_dtype
        image_f, task = self.nets["Image_f"], self.nets["Task"]
        syn_i = batch["A_i"].to(dt).permute(0, 3, 1, 2)
        real_i = batch["B_i"].to(dt).permute(0, 3, 1, 2)
        if not getattr(self.opt, "no_batched_branches", False):
            bsz = syn_i.shape[0]
            feats = image_f(torch.cat([syn_i, real_i], 0))
            pred = task(feats)[:, 0].float()
            return feats[:bsz], feats[bsz:], pred[:bsz], pred[bsz:]
        feats_syn, feats_real = image_f(syn_i), image_f(real_i)
        return (feats_syn, feats_real, task(feats_syn)[:, 0].float(),
                task(feats_real)[:, 0].float())

    def losses(self, pred_syn, pred_real, batch):
        """(loss_G, metrics) of i2d_model.py:117-138."""
        opt = self.opt
        syn_d, real_d = batch["A_d"][..., 0], batch["B_d"][..., 0]
        mask_syn = (syn_d >= BORDER).float()
        mask_real = (real_d >= BORDER).float()
        m = {"task_syn": L.l1_loss(syn_d * mask_syn, pred_syn * mask_syn),
             "task_real": L.l1_loss(real_d * mask_real, pred_real * mask_real)}
        if opt.norm_loss:  # a metric only (I2D_model.py:217 vs :226)
            sp = S.active(self.spatial)
            m["syn_norms"] = L.l1_loss(NRM.surface_normals_planar(syn_d, spatial=sp),
                                       NRM.surface_normals_planar(pred_syn, spatial=sp))
        loss_g = (m["task_syn"] * opt.w_syn_l1 + m["task_real"] * opt.w_real_l1) * opt.scale_G
        m["G"] = loss_g
        return loss_g, m

    def _d_logits(self, feats, train=True, track=False):
        """D_depth's float32 logits; a BatchNorm in it (--norm batch) runs in
        ``train`` mode and moves its statistics only with ``track`` (the D
        step's stats sink, i2d_model.py:205-216)."""
        with batch_norm_mode(train, track):
            return self.nets["D_depth"](feats).float()

    def stage(self, batch):
        """(device tensors, paths) of this rank's rows of a host batch
        (``--direction BtoA`` swaps the domains)."""
        batch = self.shard(batch)
        rows, h_rows = batch.rows, batch.h_rows
        batch = self.apply_direction(batch)
        return (Shard({k: _to_device(batch[k], self.device).float() for k in INPUT_KEYS}, rows,
                      h_rows),
                {"A_paths": batch.get("A_paths"), "B_paths": batch.get("B_paths")})

    def compute_grads(self, batch=None):
        """Forward, loss_G and its backward (i2d_model.py:141-179); the
        gradients, averaged over the ranks, are left on the trainable nets'
        parameters. Returns this rank's metrics. The features are kept,
        detached, for the D step."""
        batch = self._batch if batch is None else batch
        self.optimizer.zero_grad(set_to_none=True)
        with self.step_layout(batch):
            feats_syn, feats_real, pred_syn, pred_real = self.forward_all(batch)
            loss_g, m = self.losses(pred_syn, pred_real, batch)
            if self.use_D and "Image_f" in self.trainable_nets:
                # the reference's unweighted loss_G_pred through the frozen D
                loss_g = loss_g + L.gan_loss(self._d_logits(feats_real), True, self.opt.gan_mode)
            loss_g.backward()
        self.reduce_grads(self.trainable_nets)
        self._feats = (feats_syn.detach(), feats_real.detach())
        return {k: v.detach() for k, v in m.items()}

    def d_step(self, feats_syn, fake):
        """One Adam step of D_depth on 0.5 (GAN(D(feats_syn), True) +
        GAN(D(fake), False)) (i2d_model.py:197-216); returns the loss."""
        mode, net = self.opt.gan_mode, self.nets["D_depth"]
        net.requires_grad_(True)
        try:
            self.optimizer_D.zero_grad(set_to_none=True)
            loss = 0.5 * (L.gan_loss(self._d_logits(feats_syn, track=True), True, mode)
                          + L.gan_loss(self._d_logits(fake, track=True), False, mode))
            loss.backward()
            self.reduce_grads(["D_depth"])
            self.optimizer_D.step()
        finally:
            net.requires_grad_(False)
        return loss.detach()

    def optimize_parameters(self, iters=0, fr=700):
        """One train step: G (forward, loss_G backward, Adam); under
        ``--use_D`` then the D step, every ``fr * batch_size`` images and at
        each of the first 800 (i2d_model.py:245-258), and the G_pred metrics.

        The D step and the metrics read the eval forward's features of the
        updated ``Image_f``, as the JAX step does: those of G's forward when
        ``Image_f`` neither trains nor holds a BatchNorm, else a fresh eval
        forward of it."""
        self.metrics = self.compute_grads()
        self.optimizer.step()
        if self.use_D:
            with self.step_layout(self._batch):
                self._d_and_g_pred(iters, fr)
        self.metrics = self.global_metrics(self.metrics)

    def _d_and_g_pred(self, iters, fr):
        """The --use_D half of ``optimize_parameters``."""
        feats_syn, feats_real = self._feats
        if "Image_f" in self.trainable_nets or self.opt.norm == "batch":
            with torch.no_grad():
                feats_syn, feats_real = self.forward_all(self._batch, train=False)[:2]
        if iters % (fr * self.opt.batch_size) == 0 or iters < 800:
            # the JAX step queries one host pool with the global batch
            # (i2d_model.py:251); every rank holds an identical pool, queried
            # with whole frames, and keeps its rows of B and of H
            sp = S.active(self.spatial)
            whole = feats_real if sp is None else S.gather_h(feats_real, sp)
            batch_group = self.mesh.batch_group if self._batch.split else None
            fake = self.fake_depth_pool.query(all_gather_rows(whole, batch_group))
            if batch_group is not None:
                lo, hi, _ = self._batch.rows
                fake = fake[lo:hi]
            if sp is not None:
                fake = S.take_h(fake, sp).contiguous()
            self.metrics["D_depth"] = self.d_step(feats_syn, fake)
        with torch.no_grad():
            mode = self.opt.gan_mode
            self.metrics["G_pred"] = L.gan_loss(self._d_logits(feats_real, False), True, mode)
            self.metrics["G_pred_r"] = L.gan_loss(self._d_logits(feats_syn, False), True, mode)

    @torch.no_grad()
    def calculate(self, stage="test"):
        """The eval forward, its losses and its visuals (i2d_model.py:260-264:
        NHWC images, planar depths and predictions); with ``--save_all`` the
        test predictions are written as uint16 PNGs (rows [16:-16])."""
        batch = self._batch
        with self.step_layout(batch):
            _, _, pred_syn, pred_real = self.forward_all(batch, train=False)
            self.metrics = self.global_metrics(self.losses(pred_syn, pred_real, batch)[1])
        vis = {"syn_image": batch["A_i"], "syn_depth": batch["A_d"][..., 0],
               "pred_syn_depth": pred_syn, "real_image": batch["B_i"],
               "real_depth": batch["B_d"][..., 0], "pred_real_depth": pred_real}
        self.visuals = self.whole_frames({k: vis[k] for k in self.visual_names})
        if getattr(self.opt, "save_all", False) and stage == "test":
            self._dump_predictions(pred_real)
