"""Stage 3b: the x2 SR fine-tune of the main network (counterpart of
``desr_tpu/models/main_sr_model.py``).

The nets are MainModel's; ``Task`` is the plain U-Net, run on the HR grid
(main_model.py:122-126 builds it without the SR head, and
main_sr_model.py:71 keeps it). The batch is HR (twice ``--crop_size_h/_w``).
The image guidance runs at LR: each image is bicubic-downsampled to
(crop_h, crop_w) for ``I2D_features`` and ``Image2Depth``, and their features
and depth prior are bicubic-upsampled back to HR (main_sr_model.py:166-172),
where ``Depth_f`` and ``Task`` predict ``pred_real_depth_hr``. The losses
compare at both grids (:239-351). Resizes are torch-exact (``ops/resize.py``).

As-shipped quirks kept (main_sr_model.py:11-29):
- holes: size fractions //150..//10, p 0.95 (real) and 0.90 (synthetic);
- ``syn_norms_old`` is an unmasked L1; ``norm_real_pred_hr`` uses K_A and
  crop_A; ``syn_norms`` compares the synthetic normals with the HR real ones;
- ``task_real_by_image`` is anchored to the nearest-resized synthetic depth;
- weights x2 on ``tv_real_norm`` and ``tv_real_norm_old``, x5 on
  ``syn_norms_old``;
- ``--use_D`` is refused (the reference reads a loss it never computes);
- ``--use_rec_as_real_input`` re-degrades the real branch through a zoo-A
  ``G_B_d`` that runs frozen at its random init and is never saved or
  loaded (QUIRKS #31): the real input becomes G_A_d(G_B_d(depth ++ image),
  image), while the masks stay on the original depth.

Under ``--spatial_devices`` the HR->LR resizes of the step work on the
rank's band (``ops/resize.py:_resize_band``; bicubic reads two rows of each
neighbour) and their backward goes through the exchange's adjoint.
"""

from __future__ import annotations

import torch

from desr_tpu_torch import tracing
from desr_tpu_torch.models import networks
from desr_tpu_torch.models.main_model import BORDER, MainModel, ServingForward
from desr_tpu_torch.ops import losses as L
from desr_tpu_torch.ops import normals as NRM
from desr_tpu_torch.ops.masked_loss import fused_hole_means
from desr_tpu_torch.ops.resize import resize_bicubic_planar, resize_nearest_planar
from desr_tpu_torch.parallel import spatial as S


class SRServingForward(ServingForward):
    """``ServingForward`` of the SR stage (the JAX ``_forward_fn``,
    main_sr_model.py:108, read at ``pred_real_depth_hr``): the input grid is
    the HR one, ``hr_hw``; the image guidance runs at ``lr_hw``."""

    def __init__(self, nets, compute_dtype, lr_hw, hr_hw):
        super().__init__(nets, compute_dtype)
        self.lr_hw, self.hr_hw = tuple(lr_hw), tuple(hr_hw)

    def guidance(self, images):
        """LR guidance, upsampled to HR (main_sr_model.py:166-172): the casts
        to the compute dtype after each resize are the JAX package's. On a
        rank's band of rows (``spatial``) each resize gives the rank's band
        of its output (``ops/resize.py``)."""
        dt, sp = self.compute_dtype, self.spatial
        lr_img = resize_bicubic_planar(images.float(), self.lr_hw, sp).to(dt)
        feats, dbi = super().guidance(lr_img)
        return (resize_bicubic_planar(feats.float(), self.hr_hw, sp).to(dt),
                resize_bicubic_planar(dbi, self.hr_hw, sp))


class MainSRModel(MainModel):
    """MainSRModel (main_sr_model.py:58-364) on one device; arguments as
    ``MainModel``'s. ``serve_forward`` returns ``pred_real_depth_hr`` on the
    input grid, which must be twice (crop_size_h, crop_size_w)."""

    _supports_rec_input = True
    _dump_key, _dump_rows = "pred_real_depth_hr", 32
    _hole_p, _hole_max_frac = (0.95, 0.90), 10  # main_sr_model.py:188-198

    def __init__(self, opt=None, device=None, compute_dtype=torch.bfloat16, **kw):
        if getattr(opt, "use_D", False):
            raise NotImplementedError(
                "--use_D in the SR model references loss_G_pred that the reference "
                "never computes (main_sr_model.py:466); unsupported")
        super().__init__(opt, device, compute_dtype, **kw)
        self.lr_hw = (self.opt.crop_size_h, self.opt.crop_size_w)
        self.hr_hw = (2 * self.opt.crop_size_h, 2 * self.opt.crop_size_w)

    def _frozen_extra_nets(self, opt, common):
        """G_B_d of --use_rec_as_real_input (main_sr_model.py:72-81): frozen,
        at its random init, outside ``model_names`` (never saved or loaded)."""
        if not getattr(opt, "use_rec_as_real_input", False):
            return {}
        return {"G_B_d": networks.define_G(4, 1, opt.ngf, opt.netG,
                                           **dict(common, use_dropout=not opt.no_dropout))}

    def serving_module(self):
        """``SRServingForward``: the real branch at the SR grids."""
        return SRServingForward(self.nets, self.compute_dtype, self.lr_hw, self.hr_hw)

    def _real_input_depth(self, batch, real_depth, real_image, train):
        if "G_B_d" not in self.nets:
            return real_depth
        # main_sr_model.py:151-162: r2s = G_B_d(depth ++ image), then G_A_d;
        # G_B_d goes through run_net as in the JAX remat (:158), though as a
        # frozen net under no_grad it is never checkpointed
        dt = self.compute_dtype
        r2s = self.run_net("G_B_d", torch.cat([batch["B_d"].to(dt).permute(0, 3, 1, 2),
                                               real_image], 1), train=train)
        with tracing.span("net.G_A_d"):
            rec = self.nets["G_A_d"](r2s.to(dt), real_image)
        return rec[:, 0].float()

    def _forward_all(self, batch, train):
        """MainModel's forward on the SR grids (main_sr_model.py:125-235); the
        real prediction is also bicubic-downsampled to LR (:223)."""
        f = super()._forward_all(batch, train)
        f["pred_real_depth_hr"] = f["pred_real_depth"]
        f["pred_real_depth"] = resize_bicubic_planar(f["pred_real_depth_hr"], self.lr_hw,
                                                     self.spatial)
        return f

    def losses(self, f, batch):
        """(loss_G, metrics) of the SR zoo (main_sr_model.py:239-351); the
        (task, holes, holes_l2) triplets run on K3 (``fused_hole_means``)."""
        opt, lr_hw = self.opt, self.lr_hw
        sp, group = S.active(self.spatial), self.step_group
        m = {}
        syn_depth, syn_mask = f["syn_depth"], f["syn_mask"]
        pred_syn, pred_real, pred_real_hr = (f["pred_syn_depth"], f["pred_real_depth"],
                                             f["pred_real_depth_hr"])

        def nearest(t):
            return resize_nearest_planar(t, lr_hw, sp)

        # the real branch at LR (:257-261)
        real_mask = nearest(f["real_mask"])
        real_hole_mask = nearest(f["real_hole_mask"])
        real_depth = resize_bicubic_planar(f["real_depth"], lr_hw, sp)
        real_image = resize_bicubic_planar(f["real_image"].float().permute(0, 3, 1, 2), lr_hw, sp)
        mask_syn_add_holes = ((f["syn2real_depth_masked"] < BORDER)
                              | (f["gt_mask_syn"] < 0.1)).float()

        zero = torch.zeros((), device=pred_syn.device)
        for k in ("tv_syn_norm", "tv_real_norm", "tv_syn_norm_old", "tv_real_norm_old",
                  "syn_norms_old", "syn_norms_holes", "syn_norms"):
            m[k] = zero
        if opt.norm_loss:
            mask1 = syn_mask[:, None]
            # legacy image-space normals, x100 (:272-278)
            norm_syn_o = NRM.surface_normals_planar(syn_depth, spatial=sp) * 100
            norm_syn_pred_o = NRM.surface_normals_planar(pred_syn, spatial=sp) * 100
            norm_real_pred_hr_o = NRM.surface_normals_planar(pred_real_hr, spatial=sp) * 100
            m["tv_syn_norm_old"] = L.tv_loss_planar(norm_syn_pred_o, group, sp) * 1e-7
            m["tv_real_norm_old"] = L.tv_loss_planar(norm_real_pred_hr_o, group, sp) * 1e-7
            m["syn_norms_old"] = L.l1_loss(norm_syn_o, norm_syn_pred_o)  # unmasked (:278)
            # intrinsics-based normals (:280-292)
            normals = lambda d, k: NRM.surface_normals_from_K_planar(  # noqa: E731
                d, batch["K_" + k], batch["crop_" + k], spatial=sp)
            norm_syn, norm_syn_pred = normals(syn_depth, "A"), normals(pred_syn, "A")
            norm_real_pred = normals(pred_real, "B")
            # as shipped: the HR real normals with K_A / crop_A (:286)
            norm_real_pred_hr = normals(pred_real_hr, "A")
            m["tv_syn_norm"] = L.tv_loss_planar(norm_syn_pred, group, sp) * 1e-7
            m["tv_real_norm"] = L.tv_loss_planar(norm_real_pred, group, sp) * 1e-7
            # as shipped: synthetic normals against the HR real ones (:290)
            m["syn_norms"] = L.mse_loss(norm_syn * mask1, norm_real_pred_hr * mask1)
            mask2 = (syn_mask * mask_syn_add_holes)[:, None]
            m["syn_norms_holes"] = L.l1_loss(norm_syn * mask2, norm_syn_pred * mask2)

        m["task_syn"], m["holes_syn"], m["holes_syn_l2"] = fused_hole_means(
            pred_syn, syn_depth, syn_mask, mask_syn_add_holes)
        m["task_real_by_depth"] = L.l1_loss(real_depth * real_mask, pred_real * real_mask)
        # as shipped: anchored to the nearest-resized synthetic depth (:307-309)
        syn_depth_lr = nearest(syn_depth)
        m["task_real_by_image"] = L.l1_loss(syn_depth_lr * real_hole_mask,
                                            pred_real * real_hole_mask)

        # weighted sum (:312-319)
        loss_g = (m["task_syn"] * opt.w_syn_l1
                  + m["holes_syn"] * opt.w_syn_holes
                  + m["holes_syn_l2"] * opt.w_syn_holes
                  + m["task_real_by_depth"] * opt.w_real_l1_d
                  + m["task_real_by_image"] * opt.w_real_l1_i
                  + m["tv_syn_norm"] * 1 + m["syn_norms_holes"] * opt.w_syn_norm * 5
                  + m["tv_real_norm"] * 2 + m["syn_norms_old"] * opt.w_syn_norm * 5
                  + m["tv_real_norm_old"] * 2 + m["tv_syn_norm_old"] * 1)
        if self.use_masked:
            mask_real_add_holes = nearest((f["gt_mask_real"] <= 0.1).float())
            m["holes_real"], _, m["holes_real_l2"] = fused_hole_means(
                pred_real, real_depth, mask_real_add_holes, torch.ones_like(mask_real_add_holes))
            loss_g = loss_g + (m["holes_real"] + m["holes_real_l2"]) * opt.w_real_holes
        if opt.norm_loss:
            loss_g = loss_g + m["syn_norms"] * opt.w_syn_norm
        if opt.use_smooth_loss:
            m["smooth"] = L.smooth_weight_loss_planar(pred_real, real_image, 3, sp)
            loss_g = loss_g + m["smooth"] * opt.w_smooth
        loss_g = loss_g * opt.scale_G
        m["G"] = loss_g

        m["syn_mean_diff"] = (syn_depth * syn_mask).mean() - (pred_syn * syn_mask).mean()
        m["real_mean_diff"] = (real_depth * real_mask).mean() - (pred_real * real_mask).mean()
        m["mean_of_abs_diff_syn"] = (syn_depth * syn_mask - pred_syn * syn_mask).abs().mean()
        m["mean_of_abs_diff_real"] = (real_depth * real_mask - pred_real * real_mask).abs().mean()
        m["L1_syn"] = m["mean_of_abs_diff_syn"]
        m["L1_real"] = m["mean_of_abs_diff_real"]
        return loss_g, m
