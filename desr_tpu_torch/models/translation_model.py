"""Stage 2 — unpaired HQ <-> LQ depth translation (counterpart of
``desr_tpu/models/translation_model.py``), its serving forward only.

``G_A`` (synthetic/HQ -> real/LQ) and ``G_B`` (real/LQ -> synthetic/HQ) are
the dual-encoder translators of ``translation_networks.define_Gen`` with the
``img_depth`` input (translation_model.py:115-118); their ResnetBlockT
bottlenecks run on K1. ``serve_forward`` applies one of them to each RGB-D
frame: AtoB gives ``fake_depth_B`` = G_A(depth, image), BtoA gives
``fake_depth_A`` = G_B(depth, image) (:172-177). Training (the G/D
alternation, the discriminators, the cycle and normal losses; the train
options refuse ``--model_type translation``) and ``--inp_B depth`` are not
yet ported.
"""

from __future__ import annotations

import torch

from desr_tpu_torch.models import translation_networks as TN
from desr_tpu_torch.models.base_model import BaseModel
from desr_tpu_torch.models.main_model import NetOptions, _to_device


class TranslationModel(BaseModel):
    """The two translators on one device, for serving.

    ``opt``: ``NetOptions`` (``init_type``, ``inp_B``); ``direction``: "AtoB"
    or "BtoA", the generator ``serve_forward`` applies.
    """

    model_names = ("G_A", "G_B")

    def __init__(self, opt=None, device=None, compute_dtype=torch.bfloat16, generator=None,
                 direction="AtoB"):
        opt = opt or NetOptions()
        if getattr(opt, "inp_B", "img_depth") != "img_depth":
            raise NotImplementedError(f"--inp_B {opt.inp_B}: not yet ported (img_depth is)")
        if direction not in ("AtoB", "BtoA"):
            raise ValueError(f"direction {direction!r}: AtoB or BtoA")
        super().__init__(opt, device, compute_dtype)
        if generator is None:
            generator = torch.Generator().manual_seed(getattr(opt, "seed", 0))
        gen_opt = TN.default_translator_opt(init_type=opt.init_type)
        self.nets = torch.nn.ModuleDict(
            {n: TN.define_Gen(gen_opt, "img_depth", generator=generator) for n in self.model_names})
        self.direction = direction
        self.to(self.device)
        self.eval()
        self.requires_grad_(False)

    @torch.no_grad()
    def serve_forward(self, batch):
        """The translated depth (B, H, W) float32 of "B_d" (B, H, W, 1) and
        "B_i" (B, H, W, 3), both in [-1, 1], numpy arrays or tensors:
        ``fake_depth_B`` under AtoB, ``fake_depth_A`` under BtoA."""
        dt = self.compute_dtype
        depth = _to_device(batch["B_d"], self.device).to(dt).permute(0, 3, 1, 2)
        image = _to_device(batch["B_i"], self.device).to(dt).permute(0, 3, 1, 2)
        net = self.nets["G_A" if self.direction == "AtoB" else "G_B"]
        return net(depth, image)[:, 0].float()
