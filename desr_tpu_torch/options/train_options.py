"""Training options for ``python -m desr_tpu_torch.train`` (counterpart of
``desr_tpu/options/{base,train}_options.py`` with the stages' own flags,
main_model.py:67-75, i2d_model.py:39-47, translation_model.py:49-74):
``--model_type main`` (``--SR`` trains the x2 SR fine-tune), ``I2D`` or
``translation``.

Every flag of the JAX parser is known here, under its JAX name. Those the
port honours keep the JAX defaults (several are read by no part of the main
stage in either package, as in the reference). ``XLA_ONLY``, the JAX
package's switches of XLA's lowering, compiler and buffers, which have no
counterpart in the port, stop the run. An unknown flag gets argparse's own
error. The port adds ``--device`` (default ``cuda``). ``--num_devices`` N
trains on N ranks (``desr_tpu_torch/parallel``), ``--batch_size`` being the
global batch; ``--spatial_devices`` S (dividing N) makes them N / S data
groups of S ranks that split each frame's rows, for every ``--model_type``,
under the remat flags, ``--steps_per_call`` and ``--device_aug``.

``--remat_tails`` keeps the JAX default None, which the JAX models turn into
their per-stage default (on for SR, I2D and translation); the port reads None
as off (see ``models/base_model.py:remat_modes``).
"""

from __future__ import annotations

import argparse
import os

# XLA-lowering switches of the JAX package (layers.py Ctx): same math there;
# and XLA's compiler options, buffer donation and compile cache
XLA_ONLY = ("pallas_fuse", "no_pallas_fuse", "pallas_fuse_frozen", "fused_pad",
            "no_split_conv", "row_tap", "phase_convt", "no_ring_pad", "no_tap_conv",
            "fold_norm", "bf16_tail", "bf16_normals", "no_onepass_stats",
            "compiler_option", "no_donate", "compile_cache_dir")
LR_POLICIES = ("linear", "step", "cosine", "plateau")
COMPUTE_DTYPES = ("bfloat16", "bf16", "float32", "f32")

# (name, type, default) of the valued flags the port accepts
_VALUED = [
    # base_options.py:25-76
    ("dataroot", str, "./"), ("name", str, "experiment_name"), ("gpu_ids", str, "0"),
    ("model_type", str, "I2D"), ("checkpoints_dir", str, "./checkpoints"),
    ("model", str, "cycle_gan"), ("input_nc", int, 3), ("output_nc", int, 3), ("ngf", int, 64),
    ("ndf", int, 64), ("netD", str, "basic"), ("netG", str, "resnet_9blocks"),
    ("n_layers_D", int, 3), ("norm", str, "instance"), ("init_type", str, "normal"),
    ("init_gain", float, 0.02), ("dataset_mode", str, "unaligned"), ("direction", str, "AtoB"),
    ("num_threads", int, 4), ("batch_size", int, 1), ("batch_size_val", int, 1),
    ("load_size", int, 286), ("crop_size", int, 256), ("max_dataset_size", int, 2 ** 31),
    ("preprocess", str, "resize_and_crop"), ("display_winsize", int, 256),
    ("epoch", str, "latest"), ("load_iter", int, 0), ("suffix", str, ""),
    ("compute_dtype", str, "bfloat16"), ("seed", int, 0), ("profile_dir", str, ""),
    ("steps_per_call", int, 1), ("num_devices", int, 0), ("spatial_devices", int, 1),
    # train_options.py:12-136
    ("display_freq", int, 400), ("display_ncols", int, 4), ("display_id", int, 1),
    ("display_server", str, "http://localhost"), ("display_env", str, "main"),
    ("display_port", int, 2346), ("update_html_freq", int, 1000), ("print_freq", int, 100),
    ("save_latest_freq", int, 500), ("save_epoch_freq", int, 10), ("epoch_count", int, 1),
    ("phase", str, "train"), ("start_iter", int, 0), ("n_epochs", int, 100),
    ("n_epochs_decay", int, 100), ("beta1", float, 0.5), ("lr", float, 0.0002),
    ("gan_mode", str, "lsgan"), ("pool_size", int, 50), ("lr_policy", str, "linear"),
    ("lr_decay_iters", int, 50), ("max_distance", int, 10),
    ("save_image_folder", str, "./predictions/"), ("update_ratio", int, 1), ("take", int, 0),
    ("path_to_intr", str, ""), ("split_files", str, ""), ("path_A", str, ""),
    ("path_B", str, ""), ("path_A_test", str, ""), ("path_B_test", str, ""),
    ("A_add_paths", str, ""), ("B_add_paths", str, ""), ("A_add_paths_test", str, ""),
    ("B_add_paths_test", str, ""), ("num_test", int, 5000), ("iou_error_weight", float, 0.5),
    ("Imagef_ndown", int, 2), ("Depthf_ndown", int, 2), ("Task_ndown", int, 2),
    ("Imagef_basef", int, 32), ("Depthf_basef", int, 32), ("Task_basef", int, 64),
    ("Imagef_outf", int, 16), ("Depthf_outf", int, 128), ("Imagef_type", str, "resnet_6blocks"),
    ("Depthf_type", str, "resnet_6blocks"), ("Task_type", str, "unet_128"),
    ("w_syn_adv", float, 0.5), ("w_real_l1", float, 0.1), ("w_holles", float, 0.0),
    ("w_syn_norm", float, 0.0), ("w_real_norm", float, 0.0), ("w_edge_s", float, 0.0),
    ("w_edge_r", float, 0.0), ("w_rec_holles", float, 0.0), ("w_syn_l1", float, 1),
    ("w_syn_holes", float, 2), ("w_real_holes", float, 5), ("w_real_l1_d", float, 1),
    ("w_real_l1_i", float, 0.1), ("w_smooth", float, 0.1), ("w_tv", float, 0.1),
    ("w_norm_idt", float, 0), ("w_norm_cycle", float, 0), ("w_loss_l1", float, 0.1),
    ("w_edge_l1", float, 1), ("w_ssim", float, 1), ("ImageDepthf_outf", int, 128),
    ("ImageDepthf_basef", int, 32), ("ImageDepthf_type", str, "resnet_6blocks"),
    ("I2D_base", int, 64), ("I2D_type", str, "unet_128"), ("scale_G", float, 1.0),
    ("notscannet", bool, True), ("load_size_h", int, 480), ("load_size_w", int, 640),
    ("crop_size_h", int, 384), ("crop_size_w", int, 512),
    # main_model.py:71-74, i2d_model.py:43-46
    ("lambda_A", float, 10.0), ("lambda_B", float, 10.0), ("lambda_identity", float, 0.5),
    # translation_model.py:49-74 (--max_distance keeps its default 10 there
    # too, :75-80: the README's stage-2 command passes 5100)
    ("l_cycle_A_begin", float, 10.0), ("l_cycle_A_end", float, 10.0),
    ("l_cycle_B_begin", float, 5.0), ("l_cycle_B_end", float, 5.0),
    ("l_identity", float, 1.0), ("l_normal", float, 1.0),
    ("l_reconstruction_semantic", float, 0.0), ("l_depth_A_begin", float, 5.0),
    ("l_depth_A_end", float, 0.0), ("l_depth_B_begin", float, 5.0),
    ("l_depth_B_end", float, 0.0), ("l_mean_A", float, 0.0), ("l_mean_B", float, 0.0),
    ("l_tv_A", float, 0.0), ("l_max_iter", int, 5000), ("l_num_iter", int, 5000),
    ("num_iter_gen", int, 3), ("num_iter_dis", int, 1), ("inp_B", str, "img_depth"),
    ("norm_d", str, "none"), ("w_decay_G", float, 0.0001),
]
# store_true flags the port accepts (no_dropout defaults True in the main and I2D
# stages, parse_with)
_SWITCHES = [
    "use_spnorm", "serial_batches", "no_flip", "verbose", "i2d_train_features", "fused_iter",
    "pallas_losses", "no_batched_branches", "no_html", "save_by_iter", "continue_train",
    "replace_transpose", "uint16", "custom_pathes", "image_and_depth", "eval", "print_mean",
    "cat", "use_rec_masks", "use_idt_masks", "save_all", "use_rec_iou_error",
    "back_rec_iou_error", "use_rec_as_real_input", "use_image_for_trans", "norm_loss",
    "use_smooth_loss", "use_D", "use_edge", "use_masked", "use_scannet", "use_tv", "do_train",
    "do_test", "interiornet", "no_aug", "use_i2d_in_input", "SR", "device_aug",
    "use_wandb", "remat", "remat_blocks",
]


# the flags whose meaning the port states (the rest are the JAX package's)
_HELP = {
    "num_threads": "loader workers per rank (spawned; 0 or 1: inline)",
    "batch_size": "the global batch: over --num_devices N ranks each trains on 1/N of it",
    "num_devices": "data-parallel ranks: N > 1 spawns N processes, one a card (NCCL), or "
                   "under --device cpu N CPU ranks (gloo); 0: every visible card "
                   "(one under --device cpu); more than the visible cards raises",
    "spatial_devices": "the image-H axis of the mesh: S > 1 (dividing the ranks) makes "
                       "N / S data groups of S ranks that split each frame's rows "
                       "(every stage)",
}


def build_parser():
    p = argparse.ArgumentParser(prog="python -m desr_tpu_torch.train")
    for name, typ, default in _VALUED:
        p.add_argument(f"--{name}", type=typ, default=default, help=_HELP.get(name))
    for name in _SWITCHES:
        p.add_argument(f"--{name}", action="store_true")
    p.add_argument("--no_dropout", action="store_true", default=True)
    # store_true flags that default to True (translation_model.py:67-71)
    for name in ("no_idt_A", "use_cycle_B", "disc_for_normals", "disc_for_depth"):
        p.add_argument(f"--{name}", action="store_true", default=True)
    p.add_argument("--use_cycle_A", action="store_true")
    # the K2 route of the ResnetBlocks (the JAX per-stage default: off)
    p.add_argument("--pallas_conv", dest="pallas_conv", action="store_true", default=None)
    p.add_argument("--no_pallas_conv", dest="pallas_conv", action="store_false")
    # the scoped tail remat; None is the JAX per-stage default, off in the port
    p.add_argument("--remat_tails", dest="remat_tails", action="store_true", default=None)
    p.add_argument("--no_remat_tails", dest="remat_tails", action="store_false")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; without a GPU, cpu must be asked for")
    for name in XLA_ONLY:
        p.add_argument(f"--{name}", dest=f"_refused_{name}", nargs="?", const=True,
                       default=None, help=argparse.SUPPRESS)
    return p


def parse(argv=None, print_options=True):
    """Parsed options with ``isTrain``; exits (argparse error) on a flag the
    port does not run."""
    return parse_with(build_parser(), argv, True, print_options)


def parse_with(parser, argv, is_train, print_options):
    """``parser``'s options, with the flags ``--dataset_mode``'s dataset adds
    (base_options.py:247-253: ``--dataset_mode template`` takes
    ``--new_dataset_option``), checked as ``parse`` says."""
    from desr_tpu_torch.data import get_option_setter

    known, _ = parser.parse_known_args(argv)
    # the stages' own default (main_model.py:70, i2d_model.py:41); stage 2 reads no such flag
    parser.set_defaults(no_dropout=known.model_type in ("main", "I2D"))
    parser = get_option_setter(known.dataset_mode)(parser, is_train)
    opt = parser.parse_args(argv)
    for name in XLA_ONLY:
        if getattr(opt, f"_refused_{name}") is not None:
            parser.error(f"--{name} steers XLA in desr_tpu and has no counterpart in desr_tpu_torch")
        delattr(opt, f"_refused_{name}")
    check_spatial(parser, opt)
    if opt.model_type not in ("main", "I2D", "translation"):
        parser.error(f"--model_type {opt.model_type} is not known to desr_tpu_torch "
                     "(it trains --model_type main, I2D and translation)")
    if opt.compute_dtype not in COMPUTE_DTYPES:
        parser.error(f"--compute_dtype must be one of {COMPUTE_DTYPES}")
    if opt.lr_policy not in LR_POLICIES:
        parser.error(f"--lr_policy {opt.lr_policy} is not implemented (one of {LR_POLICIES})")
    opt.pallas_conv = bool(opt.pallas_conv)
    opt.isTrain = is_train
    if opt.suffix:
        opt.name = opt.name + "_" + opt.suffix.format(**vars(opt))
    if print_options:
        _print_options(parser, opt)
    opt.gpu_ids = [int(s) for s in str(opt.gpu_ids).split(",") if int(s) >= 0]  # :331-332
    return opt


def check_spatial(parser, opt, n=None):
    """``parser.error`` where ``--spatial_devices`` S does not fit: S < 1,
    or S > 1 not dividing the ranks ``n`` (``--num_devices``; one under
    ``--device cpu`` when it is 0; unknown until the cards are counted
    otherwise, as when ``n`` is None)."""
    s = opt.spatial_devices
    if s < 1:
        parser.error("--spatial_devices must be at least 1")
    if s == 1:
        return
    if n is None:
        n = opt.num_devices if opt.num_devices > 0 else 1 if opt.device == "cpu" else None
    if n is not None and n % s:
        parser.error(f"--num_devices {n} does not divide by --spatial_devices {s}")


def _print_options(parser, opt):
    """The options block, non-defaults marked, also written to
    <checkpoints_dir>/<name>/<phase>_opt.txt (base_options.py:257-271)."""
    message = "----------------- Options ---------------\n"
    for k, v in sorted(vars(opt).items()):
        default = parser.get_default(k)
        comment = f"\t[default: {default}]" if v != default and k != "isTrain" else ""
        message += "{:>25}: {:<30}{}\n".format(str(k), str(v), comment)
    message += "----------------- End -------------------"
    print(message)
    expr_dir = os.path.join(opt.checkpoints_dir, opt.name)
    os.makedirs(expr_dir, exist_ok=True)
    with open(os.path.join(expr_dir, f"{opt.phase}_opt.txt"), "wt") as f:
        f.write(message + "\n")
