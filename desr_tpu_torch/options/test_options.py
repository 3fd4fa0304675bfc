"""Test options (counterpart of ``desr_tpu/options/test_options.py``): the
train CLI's flags plus ``--results_dir`` and ``--aspect_ratio`` (the stretch
``utils/util.save_image`` applies), with ``--phase`` defaulting to ``test``
and ``isTrain`` False. No entry point of either package builds them."""

from __future__ import annotations

from desr_tpu_torch.options import train_options


def build_parser():
    p = train_options.build_parser()
    p.add_argument("--results_dir", type=str, default="./results/")
    p.add_argument("--aspect_ratio", type=float, default=1.0)
    p.set_defaults(phase="test")
    return p


def parse(argv=None, print_options=True):
    """Parsed test options (``isTrain`` False), checked as ``train_options.parse``
    checks them; the options block goes to <checkpoints_dir>/<name>/test_opt.txt."""
    return train_options.parse_with(build_parser(), argv, False, print_options)
