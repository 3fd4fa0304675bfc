"""The port does what desr_tpu does: every public name of the JAX package has
a counterpart in desr_tpu_torch, or a named reason why it has none.

The JAX package is read with ``ast`` and not imported. For each of its modules
the top-level public ``def`` and ``class`` names must each
- exist in the port's module of the same path (or of the path ``MODULES``
  gives);
- or be mapped in ``MAPPED`` (or ``KERNELS``) to a port symbol, which is
  imported and found by ``getattr``;
- or be listed in ``BY_DESIGN`` under one of the ``REASONS``.
A namesake counts only where the port module defines it, not where it imports
it from elsewhere. Every ``pallas_call`` of the JAX package lies behind
public entry points that ``KERNELS`` maps to the port's Hopper kernel
wrappers.
"""

import ast
import importlib
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX = os.path.join(ROOT, "desr_tpu")
PORT = "desr_tpu_torch"

# JAX modules whose counterpart lies at another path of the port
MODULES = {
    "ops/pallas_conv.py": "ops/conv3x3.py",
    "ops/pallas_kernels.py": "ops/masked_loss.py",
    "options/base_options.py": "options/train_options.py",
}

# the public entry points behind each pallas_call, and the port's wrapper of
# the Hopper kernel that computes each
KERNELS = {
    "ops/pallas_conv.py": {
        "conv2d_pallas_fused": "ops.conv3x3:conv3x3_fused",
        "conv2d_pallas": "ops.conv3x3:conv3x3",
    },
    "ops/pallas_kernels.py": {
        "masked_loss_sums": "ops.masked_loss:masked_loss_sums",
        "masked_loss_sums_diff": "ops.masked_loss:masked_loss_grads",  # its backward
        "fused_hole_means": "ops.masked_loss:fused_hole_means",
    },
}

# JAX name -> "port.module:attribute.path"; the JAX helpers take NHWC
# arrays, their planar namesakes (B, H, W) maps or NCHW tensors
MAPPED = {
    "checkpoints.py": {
        "save_networks": "models.base_model:BaseModel.save_networks",
        "load_networks": "models.base_model:BaseModel.load_networks",
    },
    "data/__init__.py": {"dataset_for_model": "data.loader:dataset_for_model"},
    "data/loader.py": {"DataLoader": "data.loader:DataLoader"},  # torch's, which it imports
    "data/legacy_datasets.py": {"find_dataset_using_name": "data:find_dataset_using_name"},
    "models/__init__.py": {
        "create_model": "train:create_model",
        "get_option_setter": "options.train_options:parse_with",  # the stages' defaults
    },
    "models/layers.py": {  # torch.nn's modules where the layer needs nothing more
        "Identity": "models.layers:Identity",
        "ReLU": "models.layers:ReLU",
        "LeakyReLU": "models.layers:LeakyReLU",
        "Tanh": "models.layers:Tanh",
        "spatial_anchor": "parallel.spatial:Spatial.sharded",  # the split-or-whole rule
        "calculate_gain": "models.networks:calculate_gain",
        "init_weight": "models.networks:init_weight_",
        "run_block_remat": "models.layers:run_layers",
    },
    "ops/depth.py": {
        "data_to_meters": "utils.util:data_to_meters",
        "normalize_image": "data.transforms:normalize_image_np",
        "normalize_depth_int": "data.transforms:normalize_depth_np",
        "normalize_depth_float": "data.transforms:normalize_depth_np",
    },
    "ops/device_aug.py": {
        "warp_batch": "ops.device_aug:warp_affine_crop",
        "make_pair_augmenter": "ops.device_aug:augment_stack",
        "make_sr_finisher": "ops.device_aug:sr_finish_stack",
    },
    "ops/losses.py": {
        "tv_loss": "ops.losses:tv_loss_planar",
        "tv_norm": "ops.losses:tv_norm_planar",
        "cos_sim_loss": "ops.losses:cos_sim_loss_planar",
        "masked_cos_sim_loss": "ops.losses:masked_cos_sim_loss_planar",
        "scale_pyramid": "ops.losses:scale_pyramid_planar",
        "smooth_weight_loss": "ops.losses:smooth_weight_loss_planar",
    },
    "ops/normals.py": {
        "surface_normals": "ops.normals:surface_normals_planar",
        "surface_normals_fov": "ops.normals:surface_normals_fov_planar",
        "surface_normals_from_K": "ops.normals:surface_normals_from_K_planar",
        "depth_to_points": "ops.normals:depth_to_points_planar",
        "points_to_normals": "ops.normals:points_to_normals_planar",
    },
    "ops/pallas_kernels.py": {"masked_loss_sums_reference": "ops.masked_loss:masked_loss_sums_plain"},
    "options/base_options.py": {"BaseOptions": "options.train_options:build_parser"},
    "options/train_options.py": {"TrainOptions": "options.train_options:parse"},
    "options/test_options.py": {"TestOptions": "options.test_options:parse"},
}

XLA = ("an XLA-lowering variant or its switches (desr_tpu/models/layers.py:53-64): "
       "the same math as the plain layer, there to steer XLA; the port writes each "
       "layer once")
GSPMD = ("a GSPMD sharding: the port's ranks hold their own rows "
         "(parallel/mesh.py:shard_batch, replicate)")
FUNCTIONAL = ("the functional layer and Adam plumbing (params as dicts, the optimizer "
              "state as a pytree) that nn.Module and torch.optim replace")
ROUTE = ("whether the Pallas route has a VMEM tiling for a shape, else XLA's conv: "
         "the port's kernel takes every shape its layers give it and has no fallback")
REASONS = (XLA, GSPMD, FUNCTIONAL, ROUTE)

BY_DESIGN = {
    "models/layers.py": {"Ctx": XLA, "ctx_flags": XLA, "InitCfg": FUNCTIONAL,
                         "Layer": FUNCTIONAL, "Sequential": FUNCTIONAL},
    "models/base_model.py": {"split_trainable": FUNCTIONAL},
    "models/networks.py": {"Net": FUNCTIONAL},
    "ops/optim.py": {"AdamState": FUNCTIONAL, "adam_init": FUNCTIONAL,
                     "adam_update": FUNCTIONAL},
    "ops/pallas_conv.py": {"conv2d_pallas_supported": ROUTE},
    "parallel/mesh.py": {"batch_sharding": GSPMD, "replicated_sharding": GSPMD},
}


def _jax_modules():
    out = []
    for dirpath, dirs, files in os.walk(JAX):
        dirs[:] = sorted(d for d in dirs if d != "__pycache__")
        out += [os.path.relpath(os.path.join(dirpath, f), JAX) for f in files
                if f.endswith(".py")]
    return sorted(out)


JAX_MODULES = _jax_modules()


def _tree(rel):
    with open(os.path.join(JAX, rel)) as fh:
        return ast.parse(fh.read())


def _public(rel):
    """{name: ast node} of the module's top-level public defs and classes."""
    return {n.name: n for n in _tree(rel).body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))
            and not n.name.startswith("_")}


def _port_module(rel):
    path = MODULES.get(rel, rel)[:-3].removesuffix("__init__").rstrip("/")
    return PORT + ("." + path.replace("/", ".") if path else "")


def _resolve(target):
    mod, attr = target.split(":")
    obj = importlib.import_module(f"{PORT}.{mod}")
    for part in attr.split("."):
        obj = getattr(obj, part)
    return obj


def _missing(rel):
    """The public names of JAX module ``rel`` with no counterpart and no reason."""
    port_path = os.path.join(ROOT, PORT, MODULES.get(rel, rel))
    if not os.path.exists(port_path):
        return [f"{rel}: no port module {os.path.relpath(port_path, ROOT)}"]
    port = importlib.import_module(_port_module(rel))
    table = {**MAPPED.get(rel, {}), **KERNELS.get(rel, {})}
    reasons = BY_DESIGN.get(rel, {})
    bad = []
    for name in _public(rel):
        if name in reasons:
            if reasons[name] not in REASONS:
                bad.append(f"{rel}:{name}: by design, for no named reason")
            continue
        if name in table:
            try:
                obj = _resolve(table[name])
            except (ImportError, AttributeError) as e:
                bad.append(f"{rel}:{name} -> {table[name]}: {e}")
                continue
        elif getattr(getattr(port, name, None), "__module__", None) == port.__name__:
            obj = getattr(port, name)
        else:
            bad.append(f"{rel}:{name}: no counterpart defined in {port.__name__}")
            continue
        if not callable(obj):
            bad.append(f"{rel}:{name}: its counterpart is not callable")
    return bad


def test_the_jax_package_is_read_whole():
    """The ast walk sees the package (46 modules, 198 names when this test
    was written); a walk that found nothing would pass every case."""
    assert len(JAX_MODULES) >= 46
    assert sum(len(_public(rel)) for rel in JAX_MODULES) >= 198


@pytest.mark.parametrize("rel", JAX_MODULES)
def test_every_public_name_has_a_counterpart(rel):
    bad = _missing(rel)
    assert not bad, "no counterpart and no reason:\n" + "\n".join(bad)


def test_the_tables_name_only_what_the_jax_package_has():
    """No entry of the tables outlives its JAX name; no name is both mapped
    and ported by design."""
    stale = []
    for table in (MODULES, KERNELS, MAPPED, BY_DESIGN):
        for rel, names in table.items():
            if rel not in JAX_MODULES:
                stale.append(rel)
                continue
            if isinstance(names, dict):
                stale += [f"{rel}:{n}" for n in names if n not in _public(rel)]
    for rel, names in BY_DESIGN.items():
        stale += [f"{rel}:{n} mapped and by design" for n in names
                  if n in MAPPED.get(rel, {}) or n in KERNELS.get(rel, {})]
    assert not stale, stale


def _reaches(tree, target):
    """The public functions of ``tree`` whose bodies reach ``target`` (a
    module-level function) through the module's own functions."""
    funcs = {n.name: n for n in tree.body
             if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
    calls = {name: {x.id for x in ast.walk(node) if isinstance(x, ast.Name)} & set(funcs)
             for name, node in funcs.items()}
    found = set()
    for name in funcs:
        seen, todo = set(), [name]
        while todo:
            f = todo.pop()
            if f == target:
                found.add(name)
                break
            if f not in seen:
                seen.add(f)
                todo += calls[f]
    return {f for f in found if not f.startswith("_")}


def test_every_pallas_call_is_behind_a_ported_kernel():
    sites = []
    for rel in JAX_MODULES:
        with open(os.path.join(JAX, rel)) as fh:
            sites += [(rel, i) for i, line in enumerate(fh, 1) if re.search(r"pallas_call\(", line)]
    assert sorted({rel for rel, _ in sites}) == sorted(KERNELS), sites
    for rel, line in sites:
        tree = _tree(rel)
        host = [n.name for n in tree.body if isinstance(n, ast.FunctionDef)
                and n.lineno <= line <= n.end_lineno]
        assert len(host) == 1, f"{rel}:{line}: pallas_call outside a module-level function"
        entries = _reaches(tree, host[0])
        assert entries == set(KERNELS[rel]), (f"{rel}:{line}: entry points {sorted(entries)}, "
                                              f"mapped {sorted(KERNELS[rel])}")
        for name in entries:
            assert callable(_resolve(KERNELS[rel][name])), KERNELS[rel][name]
