"""The port's spans (``desr_tpu_torch/tracing.py``) on the CPU: off they
record nothing; on they nest by thread and call, map onto a profiler trace's
clock, sit at the layer boundaries of the serving call and the train step,
and change no result and no exported graph.

Small widths (tests/test_torch_serving.py's), float32, batch 1: main at
128x128, SR at LR 128x128 / HR 256x256, the translator cut to 8+8 base
channels and one block.
"""

import json
import os
import threading

import numpy as np
import pytest
import torch

from desr_tpu_torch import tracing
from desr_tpu_torch.models.main_model import MainModel, NetOptions
from desr_tpu_torch.models.main_sr_model import MainSRModel
from desr_tpu_torch.options import train_options

torch.set_num_threads(2)

SMALL = dict(ImageDepthf_outf=8, ImageDepthf_basef=8, Depthf_outf=8, Depthf_basef=8,
             I2D_base=8, Task_basef=8)
SMALL_ARGS = [a for k, v in SMALL.items() for a in (f"--{k}", str(v))]
STAGE3 = ["--model_type", "main", "--use_image_for_trans", "--use_masked", "--norm_loss",
          "--use_smooth_loss", "--compute_dtype", "float32"]
NETS = ["net.I2D_features", "net.Image2Depth", "net.Depth_f", "net.Task"]
STEP = ["step.stage", "step", "step.forward", "net.G_A_d", "net.I2D_features",
        "net.Image2Depth", "step.holes", "net.Depth_f", "net.Task", "step.losses",
        "step.backward", "step.optimizer"]


@pytest.fixture(autouse=True)
def off_after():
    """Every test starts and ends with tracing off and no spans kept."""
    tracing.disable()
    tracing.drain()
    yield
    tracing.disable()
    tracing.drain()


@pytest.fixture(scope="module")
def small_translator():
    from desr_tpu_torch.models import translation_networks as TTT

    with pytest.MonkeyPatch.context() as mp:
        full = TTT.default_translator_opt
        mp.setattr(TTT, "default_translator_opt",
                   lambda **kw: full(ngf_img=8, ngf_depth=8, n_blocks=1, **kw))
        yield


def _traced(fn, on):
    """(fn(), the spans it recorded) with tracing on or off."""
    tracing.drain()
    if on:
        tracing.enable()
    try:
        out = fn()
    finally:
        tracing.disable()
    return out, tracing.drain()


# ------------------------------------------------------------------ off

def test_off_records_nothing():
    with tracing.span("a"):
        with tracing.span("b"):
            pass
    assert tracing.drain() == []


def test_off_gives_the_same_inert_object_each_time():
    first = tracing.span("a")
    assert tracing.span("b") is first
    with first as entered:
        assert entered is None


# ------------------------------------------------------------------ on

def test_spans_nest_by_thread_and_call():
    """A root gets its own id as the call id and its children carry it; a
    span on a second thread has no parent there and is a root of its own."""
    def worker():
        with tracing.span("other"):
            with tracing.span("other.child"):
                pass

    def run():
        with tracing.span("root"):
            with tracing.span("child"):
                t = threading.Thread(target=worker)
                t.start()
                t.join(timeout=30)
                assert not t.is_alive()
                with tracing.span("grandchild"):
                    pass
        with tracing.span("root2"):
            pass

    _, spans = _traced(run, on=True)
    by = {s.name: s for s in spans}
    assert [s.name for s in spans] == ["root", "child", "other", "other.child", "grandchild",
                                       "root2"]
    root, child, grand = by["root"], by["child"], by["grandchild"]
    assert (root.parent, root.call) == (None, root.id)
    assert (child.parent, child.call) == (root.id, root.id)
    assert (grand.parent, grand.call) == (child.id, root.id)
    other, other_child = by["other"], by["other.child"]
    assert (other.parent, other.call) == (None, other.id)
    assert (other_child.parent, other_child.call) == (other.id, other.id)
    assert other.thread != root.thread == child.thread == grand.thread
    assert other.thread == other_child.thread
    assert (by["root2"].parent, by["root2"].call) == (None, by["root2"].id)
    assert root.start_ns <= child.start_ns <= grand.start_ns <= grand.end_ns <= child.end_ns
    assert child.end_ns <= root.end_ns <= by["root2"].start_ns


def test_drain_empties_the_list():
    tracing.enable()
    with tracing.span("x"):
        pass
    tracing.disable()
    assert [s.name for s in tracing.drain()] == ["x"]
    assert tracing.drain() == []


def test_offset_maps_a_span_onto_its_profiler_event(tmp_path):
    """A span's perf_counter readings plus ``offset_ns()`` land within 5 ms
    of the record_function event a CPU profiler exported for it."""
    from torch.profiler import ProfilerActivity, profile

    tracing.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for name in ("first", "second"):
            with tracing.span(name):
                torch.ones(64, 64).sum()
    tracing.disable()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    base = trace.get("baseTimeNanoseconds", 0)
    events = {e["name"]: e for e in trace["traceEvents"]
              if e.get("ph") == "X" and e.get("name") in ("first", "second")}
    spans = tracing.drain()
    assert [s.name for s in spans] == ["first", "second"]
    for s in spans:
        e = events[s.name]
        start = e["ts"] * 1000 + base
        end = (e["ts"] + e["dur"]) * 1000 + base
        assert abs(s.start_ns + tracing.offset_ns() - start) < 5e6
        assert abs(s.end_ns + tracing.offset_ns() - end) < 5e6


# ------------------------------------------------------------------ serving

def _serving_model(sr):
    opt = NetOptions(**SMALL, crop_size_h=128, crop_size_w=128)
    cls = MainSRModel if sr else MainModel
    return cls(opt, device="cpu", compute_dtype=torch.float32,
               generator=torch.Generator().manual_seed(0))


def _serving_batch(sr, b=1):
    hw = (256, 256) if sr else (128, 128)
    rng = np.random.default_rng(1)
    return {"B_d": rng.uniform(-1, 1, (b, *hw, 1)).astype(np.float32),
            "B_i": rng.uniform(-1, 1, (b, *hw, 3)).astype(np.float32)}


@pytest.fixture(scope="module", params=["main", "SR"])
def served(request):
    """Two requests through ``serve_forward`` with tracing off, then on."""
    sr = request.param == "SR"
    model, batch = _serving_model(sr), _serving_batch(sr)
    serve = lambda: [model.serve_forward(batch) for _ in range(2)]  # noqa: E731
    tracing.disable()
    off, _ = _traced(serve, on=False)
    on, spans = _traced(serve, on=True)
    return off, on, spans


def test_serve_forward_spans_each_request(served):
    """``serve`` (root) holds ``serve.upload`` and then the four nets, once
    each a request."""
    _, _, spans = served
    assert [s.name for s in spans] == 2 * (["serve", "serve.upload"] + NETS)
    for req in (spans[:6], spans[6:]):
        root = req[0]
        assert root.parent is None and {s.call for s in req} == {root.id}
        assert all(s.parent == root.id for s in req[1:])
        assert all(root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns for s in req[1:])
        assert all(a.end_ns <= b.start_ns for a, b in zip(req[1:], req[2:]))


def test_serve_forward_is_bit_identical_with_tracing_on(served):
    off, on, _ = served
    for a, b in zip(off, on):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_exported_serving_forward_has_no_span_nodes():
    """``torch.export`` of ``ServingForward`` with tracing on gives the graph
    it gives with tracing off: a span is inert while compiling."""
    model, batch = _serving_model(False), _serving_batch(False)
    module = model.serving_module()
    inputs = tuple(torch.from_numpy(batch[k]) for k in ("B_d", "B_i"))

    def graph():
        with torch.no_grad():
            program = torch.export.export(module, inputs)
        return [(n.op, str(n.target)) for n in program.graph.nodes]

    off, _ = _traced(graph, on=False)
    on, spans = _traced(graph, on=True)
    assert on == off
    assert spans == []
    assert not any("record_function" in target for _, target in on)


# ------------------------------------------------------------------ train step

def _train_batch(hw, seed=0):
    rng = np.random.default_rng(seed)
    depth_a = rng.uniform(-0.5, 1, (1, *hw, 1)).astype(np.float32)
    depth_b = rng.uniform(-0.5, 1, (1, *hw, 1)).astype(np.float32)
    depth_a[depth_a < -0.4] = -1.0
    depth_b[depth_b < -0.3] = -1.0
    k = np.array([[[577.0, 0, 320], [0, 577, 240], [0, 0, 1]]], np.float32)
    crop = np.array([[0, hw[0], 0, hw[1]]], np.float32)
    return {"A_i": rng.uniform(-1, 1, (1, *hw, 3)).astype(np.float32),
            "B_i": rng.uniform(-1, 1, (1, *hw, 3)).astype(np.float32),
            "A_d": depth_a, "B_d": depth_b, "K_A": k, "K_B": k.copy(),
            "crop_A": crop, "crop_B": crop.copy()}


def _train_model(sr):
    argv = [*STAGE3, *SMALL_ARGS, "--crop_size_h", "128", "--crop_size_w", "128",
            "--batch_size", "1", "--device", "cpu"] + (["--SR"] if sr else [])
    opt = train_options.parse(argv, print_options=False)
    cls = MainSRModel if sr else MainModel
    return cls(opt, device="cpu", compute_dtype=torch.float32, is_train=True,
               generator=torch.Generator().manual_seed(3),
               hole_generator=torch.Generator().manual_seed(5))


@pytest.fixture(scope="module", params=["main", "SR"])
def stepped(request, small_translator):
    """One train step of a fresh model with tracing off, and one of another
    built the same way with tracing on: (metrics, parameters, spans) each."""
    sr = request.param == "SR"
    batch = _train_batch((256, 256) if sr else (128, 128))
    tracing.disable()
    out = []
    for on in (False, True):
        model = _train_model(sr)

        def step():
            model.set_input(batch)
            model.optimize_parameters(1)
            return ({k: v.clone() for k, v in model.metrics.items()},
                    {k: v.detach().clone() for k, v in model.nets.state_dict().items()})

        (metrics, params), spans = _traced(step, on)
        out.append((metrics, params, spans))
    return out


def test_train_step_spans_in_order(stepped):
    """``step.stage``, then ``step`` holding the forward (the translator, the
    guidance, the holes, ``Depth_f`` and ``Task``), the loss tail, the
    backward and Adam, in that order."""
    spans = stepped[1][2]
    assert [s.name for s in spans] == STEP
    stage, step = spans[0], spans[1]
    assert stage.parent is None and step.parent is None and stage.call != step.call
    by = {s.name: s for s in spans}
    for name in ("step.forward", "step.losses", "step.backward", "step.optimizer"):
        assert by[name].parent == step.id and by[name].call == step.id
    for name in STEP[3:9]:
        assert by[name].parent == by["step.forward"].id
    phases = [by[n] for n in ("step.forward", "step.losses", "step.backward", "step.optimizer")]
    assert all(a.end_ns <= b.start_ns for a, b in zip(phases, phases[1:]))


def test_train_step_is_bit_identical_with_tracing_on(stepped):
    (m_off, p_off, s_off), (m_on, p_on, _) = stepped
    assert s_off == []
    assert m_off.keys() == m_on.keys() and p_off.keys() == p_on.keys()
    for k in m_off:
        torch.testing.assert_close(m_off[k], m_on[k], rtol=0, atol=0)
    for k in p_off:
        torch.testing.assert_close(p_off[k], p_on[k], rtol=0, atol=0)


def test_train_cli_profile_dir_holds_the_model_spans(tmp_path, small_translator):
    """``train --profile_dir`` on the CPU: its trace.json holds the loop's
    ``train_step`` and the model's ``step.forward``, and tracing is off after."""
    from desr_tpu_torch import train
    from desr_tpu_torch.data.png import write_png

    rng = np.random.default_rng(0)
    for dom in ("A", "B"):
        for sub in ("depth", "img"):
            os.makedirs(tmp_path / dom / sub)
        name = "scene0000_00_0000.png"
        write_png(tmp_path / dom / "depth" / name, rng.integers(0, 7000, (128, 128))
                  .astype(np.uint16))
        write_png(tmp_path / dom / "img" / name, rng.integers(0, 256, (128, 128, 3))
                  .astype(np.uint8))
    kdir = tmp_path / "intr" / "scene0000_00" / "intrinsic"
    os.makedirs(kdir)
    np.savetxt(kdir / "intrinsic_depth.txt", np.diag([570.0, 571.0, 1.0, 1.0]))
    data = ["--path_to_intr", str(tmp_path / "intr"), "--image_and_depth", "--use_scannet",
            "--no_aug", "--load_size_h", "128", "--load_size_w", "128"]
    for dom in ("A", "B"):
        data += [f"--path_{dom}", str(tmp_path / dom / "depth"),
                 f"--{dom}_add_paths", str(tmp_path / dom / "img")]
    prof = tmp_path / "prof"
    train.main([*STAGE3, *SMALL_ARGS, *data, "--name", "p", "--checkpoints_dir",
                str(tmp_path / "ck"), "--do_train", "--continue_train", "--batch_size", "1",
                "--crop_size_h", "128", "--crop_size_w", "128", "--n_epochs", "1",
                "--n_epochs_decay", "0", "--num_threads", "0", "--no_html",
                "--profile_dir", str(prof), "--device", "cpu"])
    names = {e.get("name") for e in json.loads((prof / "trace.json").read_text())["traceEvents"]}
    assert {"train_step", "step.forward", "step.backward"} <= names
    assert tracing.span("after") is tracing.span("again")
