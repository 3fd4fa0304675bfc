"""Stage 3 — the main depth-enhancement network (counterpart of
``desr_tpu/models/main_model.py``): the serving forward and the train step.

Frozen nets from the earlier stages — the translator ``G_A_d`` and the image
guidance ``I2D_features`` + ``Image2Depth`` — turn a synthetic depth into a
realistically degraded one and predict a depth prior from each image; the
trained ``Depth_f`` + ``Task`` fuse them to fill holes and denoise. Only
``Depth_f`` and ``Task`` get Adam updates (main_model.py:142, :386-388).

Serving (``is_train=False``) builds the four nets of the real branch only:
``G_A_d`` and the synthetic branch are dead code there.

Under ``--spatial_devices`` the step runs on this rank's band of each
frame's rows (``BaseModel.step_layout``): the nets read halo rows, the masks
and normals read one row of each neighbour, the holes are cut from the
whole frames' draws, and ``calculate`` gathers its visuals along H.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from desr_tpu_torch.models import networks, translation_networks
from desr_tpu_torch.models.base_model import BaseModel
from desr_tpu_torch.models.layers import batch_norm_mode
from desr_tpu_torch.ops import depth as DPT
from desr_tpu_torch.ops import losses as L
from desr_tpu_torch.ops import normals as NRM
from desr_tpu_torch.ops.masked_loss import fused_hole_means
from desr_tpu_torch.parallel import spatial as S
from desr_tpu_torch.parallel.mesh import Shard

BORDER = -0.97  # main_model.py:44
NET_NAMES = ("I2D_features", "Image2Depth", "Depth_f", "Task")  # the serving nets
INPUT_KEYS = ("A_i", "B_i", "A_d", "B_d", "K_A", "K_B", "crop_A", "crop_B")


@dataclasses.dataclass
class NetOptions:
    """The net-width flags of TrainOptions (train_options.py:74-120) that the
    serving nets read, with their defaults (stage 3's; ``Imagef_*`` are stage
    1's, ``inp_B`` is stage 2's)."""

    ImageDepthf_outf: int = 128
    ImageDepthf_basef: int = 32
    ImageDepthf_type: str = "resnet_6blocks"
    I2D_base: int = 64
    I2D_type: str = "unet_128"
    Depthf_outf: int = 128
    Depthf_basef: int = 32
    Depthf_type: str = "resnet_6blocks"
    Depthf_ndown: int = 2
    Task_basef: int = 64
    Task_type: str = "unet_128"
    Task_ndown: int = 2
    Imagef_outf: int = 16
    Imagef_basef: int = 32
    Imagef_type: str = "resnet_6blocks"
    Imagef_ndown: int = 2
    inp_B: str = "img_depth"
    norm: str = "instance"
    replace_transpose: bool = False
    init_type: str = "normal"
    init_gain: float = 0.02
    # route the ResnetBlock convs through the plain conv3x3 kernel with
    # unfused norms (the JAX --pallas_conv route) instead of the fused chain
    pallas_conv: bool = False
    # MainSRModel's LR grid; its HR grid (the input's) is twice this
    crop_size_h: int = 384
    crop_size_w: int = 512


def _to_device(a, device):
    if torch.is_tensor(a):
        return a.to(device)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


class ServingForward(torch.nn.Module):
    """The real branch of the eval forward as one module: the JAX package's
    ``_forward_fn`` (main_model.py:146) read at ``pred_real_depth``.

    ``forward(B_d, B_i)`` takes the (B, H, W, 1) depth and (B, H, W, 3) image
    in [-1, 1], NHWC tensors on the nets' device, and returns the (B, H, W)
    float32 prediction. Live serving (``MainModel.serve_forward``) and the
    exported artifact (``desr_tpu_torch/serving.py``) both run it. It holds
    the four serving nets (shared with the model, not copied), so its
    parameters are named ``<net>.<torch key>``.
    """

    spatial = None  # the SR guidance's resizes read it (main_sr_model.py)

    def __init__(self, nets, compute_dtype):
        super().__init__()
        for name in NET_NAMES:
            self.add_module(name, nets[name])
        self.compute_dtype = compute_dtype

    def guidance(self, images):
        """(features, depth prior) of the frozen image nets: compute-dtype
        NCHW features and a float32 (B, H, W) depth, on the images' grid."""
        feats = self.I2D_features(images)
        return feats, self.Image2Depth(feats)[:, 0].float()

    def forward(self, B_d, B_i):  # noqa: N803  (the batch keys)
        dt = self.compute_dtype
        # an NHWC tensor permuted to NCHW is a channels_last NCHW tensor
        real_image = B_i.to(dt).permute(0, 3, 1, 2)
        # eval draws no holes: with p=0 the hole mask is all ones
        # (depth.py:117), so the masked depth is the depth itself
        real_depth = B_d[..., 0].float()
        feats_real, real_dbi = self.guidance(real_image)
        real_pair = torch.stack([real_depth, real_dbi], dim=1).to(dt)
        real_pair = real_pair.contiguous(memory_format=torch.channels_last)
        feat_real_d = self.Depth_f(real_pair)
        # channel order of main_model.py:237 (apply_parts is the same function)
        task_in = torch.cat([feats_real, feat_real_d, real_pair, real_image], dim=1)
        return self.Task(task_in)[:, 0].float()


class MainModel(BaseModel):
    """MainModel (main_model.py:59-463) on one device.

    ``opt``: ``NetOptions`` for serving, or the parsed train options
    (``desr_tpu_torch/options/train_options.py``) with ``is_train=True``.
    Parameters are float32; the forward runs in ``compute_dtype`` (bf16 by
    default) with float32 losses and normals. ``generator`` seeds the initial
    weights, which ``setup`` / ``load_networks`` then replace from ``.pth``
    files; ``hole_generator`` draws the train-time hole masks (on the model's
    device; seeded from ``--seed`` when None), the whole global batch's on
    every rank, which keeps its own rows. ``mesh``: this rank's data mesh
    (``BaseModel``).
    """

    model_names = ("G_A_d", "I2D_features", "Image2Depth", "Task", "Depth_f")
    trainable_nets = ("Depth_f", "Task")
    # main_model.py:99-104; calculate keeps those its forward has
    visual_names = (
        "syn_image", "syn_depth", "syn2real_depth", "syn_mask", "pred_syn_depth",
        "mask_syn_add_holes", "syn_depth_by_image", "real_image", "real_depth",
        "real_depth_by_image", "pred_real_depth", "real_mask", "mask_real_add_holes",
        "depth_masked", "syn2real_depth_masked",
        "norm_syn", "norm_syn_pred", "norm_syn2real", "norm_real", "norm_real_pred")
    _supports_rec_input = False  # --use_rec_as_real_input is the SR stage's (QUIRKS #31)
    _dump_key = "pred_real_depth"  # main_model.py:453-462
    _hole_p, _hole_max_frac = (0.90, 0.90), 8      # train-time (real, syn) p, main_model.py:210-217

    def __init__(self, opt=None, device=None, compute_dtype=torch.bfloat16,
                 use_masked=True, generator=None, is_train=False, hole_generator=None,
                 mesh=None):
        opt = opt or NetOptions()
        super().__init__(opt, device, compute_dtype, mesh)
        self.is_train = is_train
        self.use_masked = getattr(opt, "use_masked", use_masked)
        if is_train:
            self._refuse_as_shipped(opt)
            self.loss_names = self._loss_names(opt)
        else:
            self.model_names = NET_NAMES
        if generator is None:
            generator = torch.Generator().manual_seed(getattr(opt, "seed", 0))
        common = dict(norm=opt.norm, use_dropout=False, init_type=opt.init_type,
                      init_gain=opt.init_gain, replace_transpose=opt.replace_transpose,
                      generator=generator, fused=not opt.pallas_conv)
        nets = {
            "I2D_features": networks.define_G(3, opt.ImageDepthf_outf, opt.ImageDepthf_basef,
                                              opt.ImageDepthf_type, **common),
            "Image2Depth": networks.define_G(opt.ImageDepthf_outf, 1, opt.I2D_base,
                                             opt.I2D_type, **common),
            "Depth_f": networks.define_G(2, opt.Depthf_outf, opt.Depthf_basef, opt.Depthf_type,
                                         n_down=opt.Depthf_ndown, **common),
            "Task": networks.define_G(opt.ImageDepthf_outf + 5 + opt.Depthf_outf, 1,
                                      opt.Task_basef, opt.Task_type, n_down=opt.Task_ndown,
                                      **common),
        }
        if is_train:
            # frozen translator, hardcoded config (main_model.py:115-117)
            nets["G_A_d"] = translation_networks.define_Gen(
                translation_networks.default_translator_opt(), "img_depth", generator=generator)
            nets.update(self._frozen_extra_nets(opt, common))
        self.nets = torch.nn.ModuleDict(nets)
        self.to(self.device)
        # the nets' BatchNorms (--norm batch) take their mode from
        # batch_norm_mode in each forward; no other layer has one
        self.eval()
        self.requires_grad_(False)
        if is_train:
            self.apply_remat()
            self.split_trainable()
            if hole_generator is None:
                hole_generator = torch.Generator(device=self.device)
                hole_generator.manual_seed(getattr(opt, "seed", 0) + 17)
        self.hole_generator = hole_generator
        self._batch = None
        self._paths = {}

    def _frozen_extra_nets(self, opt, common):
        """Frozen train-time nets beyond the main stage's (none here)."""
        return {}

    @classmethod
    def _refuse_as_shipped(cls, opt):
        """The reference's crashing flags, refused clearly (main_model.py:79-140)."""
        if opt.use_edge:
            raise NotImplementedError(
                "--use_edge references an undefined CannyFilter in the reference "
                "(main_model.py:374-379) and is not supported")
        if not opt.use_image_for_trans:
            raise NotImplementedError(
                "the reference's non-image translation path requires netG_B_d, "
                "which MainModel never defines (main_model.py:241-249); pass "
                "--use_image_for_trans")
        if getattr(opt, "use_rec_as_real_input", False) and not cls._supports_rec_input:
            raise NotImplementedError(
                "--use_rec_as_real_input crashes the reference main stage "
                "(undefined netG_B_d, main_model.py:236-239); it is only "
                "supported with --SR")

    @staticmethod
    def _loss_names(opt):
        """main_model.py:83-98."""
        names = ["task_syn", "holes_syn", "holes_syn_l2", "task_real_by_depth",
                 "task_real_by_image", "syn_mean_diff", "real_mean_diff",
                 "tv_syn_norm", "tv_real_norm", "syn_norms_holes",
                 "tv_syn_norm_old", "tv_real_norm_old", "syn_norms_old"]
        if opt.norm_loss:
            names += ["syn_norms"]
        if opt.use_smooth_loss:
            names += ["smooth"]
        if opt.use_masked:
            names += ["holes_real", "holes_real_l2"]
        if opt.print_mean:
            names = ["syn_mean_diff", "real_mean_diff", "mean_of_abs_diff_syn",
                     "mean_of_abs_diff_real", "L1_syn", "L1_real"]
        return names

    # ------------------------------------------------------------------

    def serving_module(self):
        """The real branch of the eval forward over this model's serving nets
        (``ServingForward``), in its compute dtype."""
        return ServingForward(self.nets, self.compute_dtype)

    @torch.no_grad()
    def serve_forward(self, batch):
        """``pred_real_depth`` (B, H, W) float32 of the eval forward's real branch.

        ``batch``: "B_i" (B, H, W, 3) image and "B_d" (B, H, W, 1) depth, both
        in [-1, 1], numpy arrays or tensors (the JAX package's NHWC layout),
        uploaded to the model's device for ``serving_module()``. On a mesh
        of several ranks, this rank's rows of it (``shard``; a ``Shard`` as
        it is) and of the prediction (``serving_layout``).
        """
        batch = self.shard(batch)
        module = self.serving_module()
        with self.serving_layout(batch, module):
            return module(_to_device(batch["B_d"], self.device),
                          _to_device(batch["B_i"], self.device))

    def _guidance(self, images):
        """(features, depth prior) of the frozen image nets: compute-dtype
        NCHW features and a float32 (B, H, W) depth, on the images' grid
        (a rank's band of it under the model's ``spatial``)."""
        module = self.serving_module()
        module.spatial = self.spatial
        return module.guidance(images)

    def _real_input_depth(self, batch, real_depth, real_image, train):
        """The real depth the holes are punched into (main: the input's own)."""
        return real_depth

    def forward_all(self, batch, train):
        """The full forward (main_model.py:163-249): every tensor the losses
        and the visuals read, planar (B, H, W) for depth maps and masks.

        The frozen nets run under ``no_grad``; real and synthetic branches
        share one batch-2B call of each net unless ``--no_batched_branches``
        (under ``--norm batch`` the moments of one 2B call are not those of
        two B calls, as in the JAX package). Every BatchNorm normalises with
        the batch's moments when ``train`` and with its running statistics
        otherwise, and none moves them (the JAX step passes no stats sink).
        ``Depth_f`` and ``Task`` go through ``run_net`` (``--remat``).
        """
        with batch_norm_mode(train):
            return self._forward_all(batch, train)

    def _forward_all(self, batch, train):
        dt = self.compute_dtype
        nets = self.nets
        syn_image = batch["A_i"].to(dt).permute(0, 3, 1, 2)
        real_image = batch["B_i"].to(dt).permute(0, 3, 1, 2)
        syn_depth, real_depth = batch["A_d"][..., 0], batch["B_d"][..., 0]
        sp = S.active(self.spatial)
        real_hole_mask = DPT.hole_mask(real_depth, BORDER)
        real_mask = DPT.valid_mask(real_depth, BORDER, sp)
        syn_mask = DPT.valid_mask(syn_depth, BORDER, sp)
        batched = not getattr(self.opt, "no_batched_branches", False)
        bsz = real_image.shape[0]
        with torch.no_grad():
            syn2real = nets["G_A_d"](batch["A_d"].to(dt).permute(0, 3, 1, 2),
                                     syn_image)[:, 0].float()
            real_input_depth = self._real_input_depth(batch, real_depth, real_image, train)
            if batched:
                both_images = torch.cat([syn_image, real_image], 0)
                feats_both, dbi_both = self._guidance(both_images)
                feats_syn, feats_real = feats_both[:bsz], feats_both[bsz:]
                syn_dbi, real_dbi = dbi_both[:bsz], dbi_both[bsz:]
            else:
                feats_real, real_dbi = self._guidance(real_image)
                feats_syn, syn_dbi = self._guidance(syn_image)

        if self.use_masked:
            n, (p_real, p_syn) = (60, self._hole_p) if train else (11, (0.0, 0.0))
            holes = dict(n_max=n, max_frac=self._hole_max_frac, generator=self.hole_generator,
                         rows=getattr(batch, "rows", None),
                         h_rows=batch.h_rows if sp is not None else None)
            gt_mask_real = DPT.random_rect_holes(real_mask, p=p_real, **holes)
            depth_masked = DPT.punch_holes(real_input_depth, gt_mask_real)
            gt_mask_syn = DPT.random_rect_holes(syn_mask, p=p_syn, **holes)
            syn2real_masked = DPT.punch_holes(syn2real, gt_mask_syn)
        else:
            gt_mask_real, gt_mask_syn = torch.ones_like(real_mask), torch.ones_like(syn_mask)
            depth_masked, syn2real_masked = real_input_depth, syn2real

        syn_pair = torch.stack([syn2real_masked, syn_dbi], dim=1).to(dt)
        real_pair = torch.stack([depth_masked, real_dbi], dim=1).to(dt)
        run = lambda name, x: self.run_net(name, x, train=train)  # noqa: E731
        if batched:
            pair_both = torch.cat([syn_pair, real_pair], 0)
            feat_both_d = run("Depth_f", pair_both)
            task_in = torch.cat([feats_both, feat_both_d, pair_both, both_images], 1)
            pred_both = run("Task", task_in)[:, 0].float()
            pred_syn, pred_real = pred_both[:bsz], pred_both[bsz:]
        else:
            pred_syn = run("Task", torch.cat(
                [feats_syn, run("Depth_f", syn_pair), syn_pair, syn_image], 1))[:, 0].float()
            pred_real = run("Task", torch.cat(
                [feats_real, run("Depth_f", real_pair), real_pair, real_image], 1))[:, 0].float()

        return dict(
            syn_image=batch["A_i"], real_image=batch["B_i"],
            syn_depth=syn_depth, real_depth=real_depth,
            real_hole_mask=real_hole_mask, real_mask=real_mask, syn_mask=syn_mask,
            syn2real_depth=syn2real, syn_depth_by_image=syn_dbi,
            real_depth_by_image=real_dbi, gt_mask_real=gt_mask_real,
            gt_mask_syn=gt_mask_syn, depth_masked=depth_masked,
            syn2real_depth_masked=syn2real_masked,
            pred_syn_depth=pred_syn, pred_real_depth=pred_real,
        )

    def losses(self, f, batch):
        """(loss_G, metrics) of main_model.py:253-357; the (task, holes,
        holes_l2) triplets run on K3 (``fused_hole_means``)."""
        opt, sp, group = self.opt, S.active(self.spatial), self.step_group
        m = {}
        syn_depth, real_depth = f["syn_depth"], f["real_depth"]
        pred_syn, pred_real = f["pred_syn_depth"], f["pred_real_depth"]
        syn_mask, real_mask = f["syn_mask"], f["real_mask"]
        # translator holes + synthetic rectangles (main_model.py:268-270)
        mask_syn_add_holes = ((f["syn2real_depth_masked"] < BORDER)
                              | (f["gt_mask_syn"] < 0.1)).float()

        zero = torch.zeros((), device=pred_syn.device)
        for k in ("tv_syn_norm", "tv_real_norm", "tv_syn_norm_old", "tv_real_norm_old",
                  "syn_norms_old", "syn_norms_holes", "syn_norms"):
            m[k] = zero
        if opt.norm_loss:
            mask1 = syn_mask[:, None]
            # legacy image-space normals, x100 (main_model.py:278-285)
            norm_syn_o = NRM.surface_normals_planar(syn_depth, spatial=sp) * 100
            norm_syn_pred_o = NRM.surface_normals_planar(pred_syn, spatial=sp) * 100
            norm_real_pred_o = NRM.surface_normals_planar(pred_real, spatial=sp) * 100
            m["tv_syn_norm_old"] = L.tv_loss_planar(norm_syn_pred_o, group, sp) * 1e-7
            m["tv_real_norm_old"] = L.tv_loss_planar(norm_real_pred_o, group, sp) * 1e-7
            m["syn_norms_old"] = L.mse_loss(norm_syn_o * mask1, norm_syn_pred_o * mask1)
            # intrinsics-based normals (main_model.py:286-296)
            normals = lambda d, k: NRM.surface_normals_from_K_planar(  # noqa: E731
                d, batch["K_" + k], batch["crop_" + k], spatial=sp)
            norm_syn, norm_syn_pred = normals(syn_depth, "A"), normals(pred_syn, "A")
            norm_real_pred = normals(pred_real, "B")
            m["tv_syn_norm"] = L.tv_loss_planar(norm_syn_pred, group, sp) * 1e-7
            m["tv_real_norm"] = L.tv_loss_planar(norm_real_pred, group, sp) * 1e-7
            m["syn_norms"] = L.l1_loss(norm_syn * mask1, norm_syn_pred * mask1)
            mask2 = (syn_mask * mask_syn_add_holes)[:, None]
            m["syn_norms_holes"] = L.l1_loss(norm_syn * mask2, norm_syn_pred * mask2)

        m["task_syn"], m["holes_syn"], m["holes_syn_l2"] = fused_hole_means(
            pred_syn, syn_depth, syn_mask, mask_syn_add_holes)
        m["task_real_by_depth"] = L.l1_loss(real_depth * real_mask, pred_real * real_mask)
        m["task_real_by_image"] = L.l1_loss(f["real_depth_by_image"] * f["real_hole_mask"],
                                            pred_real * f["real_hole_mask"])

        # weighted sum, main_model.py:314-322
        loss_g = (m["task_syn"] * opt.w_syn_l1
                  + m["holes_syn"] * opt.w_syn_holes
                  + m["holes_syn_l2"] * opt.w_syn_holes
                  + m["task_real_by_depth"] * opt.w_real_l1_d
                  + m["task_real_by_image"] * opt.w_real_l1_i
                  + m["tv_syn_norm"] * 1 + m["syn_norms_holes"] * opt.w_syn_norm * 5
                  + m["tv_real_norm"] * 1 + m["syn_norms_old"] * opt.w_syn_norm
                  + m["tv_real_norm_old"] * 1 + m["tv_syn_norm_old"] * 1)
        if self.use_masked:
            mask_real_add_holes = (f["gt_mask_real"] <= 0.1).float()
            m["holes_real"], _, m["holes_real_l2"] = fused_hole_means(
                pred_real, real_depth, mask_real_add_holes, torch.ones_like(mask_real_add_holes))
            loss_g = loss_g + (m["holes_real"] + m["holes_real_l2"]) * opt.w_real_holes
        if opt.norm_loss:
            loss_g = loss_g + m["syn_norms"] * opt.w_syn_norm
        if opt.use_smooth_loss:
            img_planar = f["real_image"].float().permute(0, 3, 1, 2)
            m["smooth"] = L.smooth_weight_loss_planar(pred_real, img_planar, 3, sp)
            loss_g = loss_g + m["smooth"] * opt.w_smooth
        loss_g = loss_g * opt.scale_G
        m["G"] = loss_g

        # diagnostics (main_model.py:347-353)
        m["syn_mean_diff"] = (syn_depth * syn_mask).mean() - (pred_syn * syn_mask).mean()
        m["real_mean_diff"] = (real_depth * real_mask).mean() - (pred_real * real_mask).mean()
        m["mean_of_abs_diff_syn"] = (syn_depth * syn_mask - pred_syn * syn_mask).abs().mean()
        m["mean_of_abs_diff_real"] = (real_depth * real_mask - pred_real * real_mask).abs().mean()
        m["L1_syn"] = m["mean_of_abs_diff_syn"]
        m["L1_real"] = m["mean_of_abs_diff_real"]
        return loss_g, m

    # ------------------------------------------------------------------

    def stage(self, batch):
        """(device tensors, paths) of this rank's rows of a host batch
        (``--direction BtoA`` swaps the image and depth tensors only,
        base_model.py:161-176)."""
        batch = self.shard(batch)
        rows, h_rows = batch.rows, batch.h_rows
        batch = self.apply_direction(batch)
        return (Shard({k: _to_device(batch[k], self.device).float() for k in INPUT_KEYS}, rows,
                      h_rows),
                {"A_paths": batch.get("A_paths"), "B_paths": batch.get("B_paths")})

    def compute_grads(self, batch=None):
        """Forward, losses and backward of one train step; the gradients,
        averaged over the ranks, are left on the trainable nets' parameters.
        Returns this rank's metrics."""
        batch = self._batch if batch is None else batch
        self.optimizer.zero_grad(set_to_none=True)
        with self.step_layout(batch):
            loss_g, m = self.losses(self.forward_all(batch, train=True), batch)
            loss_g.backward()
        self.reduce_grads(self.trainable_nets)
        return {k: v.detach() for k, v in m.items()}

    def optimize_parameters(self, iters=None, fr=1):
        """One train step: forward, loss_G backward, Adam on Depth_f and Task."""
        self.metrics = self.global_metrics(self.compute_grads())
        self.optimizer.step()

    @torch.no_grad()
    def calculate(self, stage="test"):
        """The eval forward and its metrics (no holes drawn), and the visuals
        ``visual_names`` finds in the forward (main_model.py:445-449): NHWC
        images, planar depth maps and masks, whole frames on every rank of a
        spatial group. With ``--save_all`` the test predictions are written as
        uint16 PNGs."""
        with self.step_layout(self._batch):
            f = self.forward_all(self._batch, train=False)
            _, m = self.losses(f, self._batch)
        self.metrics = self.global_metrics(m)
        self.visuals = self.whole_frames({k: f[k] for k in self.visual_names if k in f})
        if getattr(self.opt, "save_all", False) and stage == "test":
            self._dump_predictions(f[self._dump_key])
