"""The port's measurement tools (clearcam_tpu_torch.tools.latency_probe,
clip_bench, clip_probe, cotenancy_bench, stem_probe, stem_kernel_probe,
tunnel_probe) on the CPU with ``--device cpu``
at their smallest settings: each tool's options are the JAX tool's plus
``--device``, its JSON lines carry the JAX tool's keys, and each refuses
``--device cuda`` without a GPU. The CLIP tools run a 1-block tower here
(the full ViT-L/14 tools are in the slow tier); the JAX tools run beside
them at the same size where that is cheap."""
import argparse
import functools
import json
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

from clearcam_tpu.models import clip as jclip
from clearcam_tpu.tools import clip_bench as jbench
from clearcam_tpu.tools import clip_probe as jprobe
from clearcam_tpu.tools import cotenancy_bench as jcot
from clearcam_tpu.tools import evaluate as jeval
from clearcam_tpu.tools import latency_probe as jlat
from clearcam_tpu.tools import mot as jmot
from clearcam_tpu.tools import stem_kernel_probe as jskp
from clearcam_tpu.tools import stem_probe as jsp
from clearcam_tpu.tools import tunnel_probe as jtunnel
from clearcam_tpu_torch.models import clip as tclip
from clearcam_tpu_torch.ops import vit_attention
from clearcam_tpu_torch.testing import torch_threads
from clearcam_tpu_torch.tools import clip_bench as tbench
from clearcam_tpu_torch.tools import clip_probe as tprobe
from clearcam_tpu_torch.tools import cotenancy_bench as tcot
from clearcam_tpu_torch.tools import evaluate as teval
from clearcam_tpu_torch.tools import latency_probe as tlat
from clearcam_tpu_torch.tools import mot as tmot
from clearcam_tpu_torch.tools import stem_kernel_probe as tskp
from clearcam_tpu_torch.tools import stem_probe as tsp
from clearcam_tpu_torch.tools import tunnel_probe as ttunnel

CPU = torch.device("cpu")
TOOLS = {"latency_probe": (jlat, tlat), "clip_bench": (jbench, tbench),
         "clip_probe": (jprobe, tprobe), "cotenancy_bench": (jcot, tcot),
         "evaluate": (jeval, teval), "mot": (jmot, tmot), "stem_probe": (jsp, tsp),
         "stem_kernel_probe": (jskp, tskp)}
# the JSON lines of the JAX cotenancy_bench (cotenancy_bench.py:196-219): it
# needs the whole NVR workload, too slow to run beside the port's here
COT_LADDER_KEYS = {"p50_ms", "p90_ms", "p99_ms", "streams_at_30fps"}
COT_FULL_KEYS = COT_LADDER_KEYS | {"summary_tok_s", "summaries_done"}
COT_FINAL_KEYS = {"metric", "value", "detect_only", "full", "config"}
COT_CONFIG_KEYS = {"streams", "slots", "llm_blocks", "vlm_res", "quant", "steps_per_tick"}


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    with torch_threads(2):
        yield


@pytest.fixture(scope="module")
def clip1():
    """A 1-block ViT-L/14 image tower in bf16 (the tools' dtype)."""
    return tclip.params_from_jax(tclip.init_params(seed=0, img_blocks=1, txt_blocks=0),
                                 CPU, torch.bfloat16)


def _parser(main) -> argparse.ArgumentParser:
    """The parser a tool's main builds, caught at parse_args."""
    seen = {}

    class Caught(Exception):
        pass

    def grab(self, *a, **k):
        seen["parser"] = self
        raise Caught

    with mock.patch.object(argparse.ArgumentParser, "parse_args", grab):
        with pytest.raises(Caught):
            main([])
    return seen["parser"]


def _options(parser) -> dict:
    """option string or positional name -> (dest, default, choices)."""
    out = {}
    for a in parser._actions:
        if isinstance(a, argparse._HelpAction):
            continue
        for name in a.option_strings or [a.dest]:
            out[name] = (a.dest, a.default, a.choices)
    return out


def _json_lines(text: str) -> list:
    return [json.loads(x) for x in text.splitlines() if x.startswith("{")]


@pytest.mark.parametrize("tool", sorted(TOOLS))
def test_options_are_the_jax_tools_plus_device(tool):
    jax_tool, port_tool = TOOLS[tool]
    ref, got = _options(_parser(jax_tool.main)), _options(_parser(port_tool.main))
    assert got.pop("--device") == ("device", "cuda", None)
    assert got == ref


@pytest.mark.parametrize("tool", sorted(TOOLS))
def test_device_cuda_raises_without_a_gpu(tool, tmp_path):
    """No tool falls back to the CPU: --device cuda (the default) raises
    before any work when torch sees no CUDA device."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    argv = {"latency_probe": ["--reps", "1"], "clip_bench": ["--batches", "1"],
            "clip_probe": ["--batches", "1"], "cotenancy_bench": ["--blocks", "1"],
            "evaluate": [str(tmp_path)], "mot": [str(tmp_path / "none.mp4")],
            "stem_probe": ["--batch", "1"], "stem_kernel_probe": ["--batch", "1"]}[tool]
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        TOOLS[tool][1].main(argv)


# ---------------------------------------------------------------------------
# latency_probe
# ---------------------------------------------------------------------------

def test_http_overhead_probe_meets_the_jax_tests_bounds():
    """tests/test_latency_probe.py's bounds, and the JAX stage's keys."""
    r = tlat.probe_http(reps=20)
    assert r["stage"] == "http_overhead"
    assert r["n"] == 20
    assert r["body_mb"] > 1.0                  # full 640x640x3 frame rode
    assert 0 < r["p50_ms"] <= r["p90_ms"] < 30_000
    assert r.keys() == jlat.probe_http(reps=2).keys()


def test_latency_probe_stages_and_keys(capsys):
    """All five stages through main, each line with the JAX stage's keys."""
    got = tlat.main(["--reps", "2", "--device", "cpu"])
    assert _json_lines(capsys.readouterr().out) == got
    ref = [jlat.probe_http(reps=2)] + jlat.probe_device(reps=2)
    assert [r["stage"] for r in got] == [r["stage"] for r in ref] == [
        "http_overhead", "device_step", "dispatch_sync", "upload_1080p", "e2e_single"]
    for a, b in zip(got, ref):
        assert a.keys() == b.keys(), a["stage"]
        assert a["p50_ms"] >= 0


# ---------------------------------------------------------------------------
# clip_bench and clip_probe
# ---------------------------------------------------------------------------

def _jax_one_block(monkeypatch):
    monkeypatch.setattr(jclip, "init_params",
                        functools.partial(jclip.init_params, img_blocks=1, txt_blocks=0))
    monkeypatch.setattr(jclip, "IMG_BLOCKS", 1)


def test_clip_bench_keys(clip1, capsys, monkeypatch):
    got = tbench.bench(clip1, [1, 2], 1, CPU)
    assert [r["batch"] for r in got] == [1, 2]
    assert all(r["images_per_s"] > 0 for r in got)
    assert _json_lines(capsys.readouterr().out) == got
    _jax_one_block(monkeypatch)
    jbench.main(["--batches", "1", "--steps", "1"])
    ref = _json_lines(capsys.readouterr().out)
    assert all(r.keys() == ref[0].keys() for r in got)


def test_clip_probe_stages_keys_and_launches(clip1, capsys, monkeypatch):
    """The JAX probe's stages in its order, each line with its keys; the
    JAX tool itself stops at full_flash, which it feeds [B,257,1024]
    activations (clip_probe.py:124) where encode_image takes pixels."""
    got = tprobe.probe(clip1, [1], 1, CPU)
    out = capsys.readouterr().out
    assert [r["stage"] for r in got] == list(tprobe.STAGES) == [
        "stem", "attn", "attn_bf16s", "mlp", "full", "full_flash"]
    printed = _json_lines(out)
    assert [{k: v for k, v in r.items() if k != "launches"} for r in got] == printed
    # on the CPU mha_flash is its plain version: no launch anywhere
    assert [r["launches"] for r in got] == [0] * 6
    assert out.count("vit_attention launches 0") == 6
    _jax_one_block(monkeypatch)
    with pytest.raises(TypeError, match="convolution requires lhs and rhs ndim"):
        jprobe.main(["--batches", "1", "--steps", "1"])
    ref = _json_lines(capsys.readouterr().out)
    assert [r["stage"] for r in ref] == ["stem", "attn", "attn_bf16s", "mlp", "full"]
    assert all(r.keys() == ref[0].keys() for r in printed)
    assert tprobe.GF_PER_IMG == jprobe.GF_PER_IMG and tprobe.PEAK_TF == 989.0


def test_clip_probe_feeds_pixels_to_the_pixel_stages(clip1, monkeypatch):
    """stem, full and full_flash get the uint8 [B,224,224,3] crops; full
    runs encode_image's plain attention, full_flash its kernel route; on the
    same pixels the two give the same scalar here, where the kernel route is
    the plain version."""
    seen, scalars = [], {}
    real = tclip.encode_image

    def spy(p, pixels, normalize=True, flash=None):
        seen.append((tuple(pixels.shape), pixels.dtype, flash))
        return real(p, pixels, normalize, flash)

    monkeypatch.setattr(tclip, "encode_image", spy)
    stages = {n: tprobe.scalar(functools.partial(tclip.encode_image, normalize=True,
                                                 flash=f))
              for n, f in (("full", False), ("full_flash", True))}
    monkeypatch.setattr(tprobe, "STAGES", stages)
    for row in tprobe.probe(clip1, [2], 1, CPU):
        scalars[row["stage"]] = row
    assert {s for s in seen} == {((2, 224, 224, 3), torch.uint8, False),
                                 ((2, 224, 224, 3), torch.uint8, True)}
    pix = torch.from_numpy(np.random.default_rng(3).integers(
        0, 255, (1, 224, 224, 3), np.uint8))
    a = tprobe.STAGES["full"](clip1, pix)
    b = tprobe.STAGES["full_flash"](clip1, pix)
    assert torch.equal(a, b) and a.dtype == torch.float32 and a.ndim == 0
    assert set(tprobe.PIXEL_STAGES) == {"stem", "full", "full_flash"}


def test_clip_probe_counts_kernel_launches_per_stage(clip1, monkeypatch):
    """The launches a stage reports are the counter's growth during it."""
    def fake_encode(p, pixels, normalize=True, flash=None):
        if flash:
            vit_attention.mha_flash.launches += 3
        return pixels.float().mean((1, 2, 3))

    monkeypatch.setattr(tprobe, "STAGES", {
        "full": tprobe.scalar(functools.partial(fake_encode, flash=False)),
        "full_flash": tprobe.scalar(functools.partial(fake_encode, flash=True))})
    n0 = vit_attention.mha_flash.launches
    rows = tprobe.probe(clip1, [1], 2, CPU)
    assert [(r["stage"], r["launches"]) for r in rows] == [("full", 0), ("full_flash", 9)]
    vit_attention.mha_flash.launches = n0


# ---------------------------------------------------------------------------
# cotenancy_bench
# ---------------------------------------------------------------------------

def test_synth_tracks_copy_equals_bench():
    import bench
    for args in ((2, 5), (3, 12, 4, 7)):
        ref, got = bench.synth_tracks(*args), tcot.synth_tracks(*args)
        assert len(ref) == len(got)
        for a, b in zip(ref, got):
            np.testing.assert_array_equal(a, b)


def test_cotenancy_bench_smallest_run(capsys, monkeypatch):
    """The whole bench at its smallest setting (2 of Qwen3-1.7B's blocks,
    ctx 256, 2 streams, 12 ticks, one crop, a 64-px VLM frame; the CLIP
    tower cut to one block): both ladders, the final line and its keys, and
    summaries that flowed."""
    monkeypatch.setattr(tclip, "init_params",
                        functools.partial(tclip.init_params, img_blocks=1, txt_blocks=0))
    final, launches = tcot.main(
        "--blocks 2 --ctx 256 --streams 2 --ticks 12 --crops 1 --vlm-res 64 "
        "--device cpu".split())
    lines = _json_lines(capsys.readouterr().out)
    assert [next(iter(x)) for x in lines] == ["detect_only", "full_cotenancy", "metric"]
    assert lines[0]["detect_only"].keys() == COT_LADDER_KEYS
    assert lines[1]["full_cotenancy"].keys() == COT_FULL_KEYS
    assert lines[2] == final and final.keys() == COT_FINAL_KEYS
    assert final["config"].keys() == COT_CONFIG_KEYS
    assert final["metric"] == "cotenancy_detect_p50_overhead_ms"
    assert final["value"] == round(final["full"]["p50_ms"] - final["detect_only"]["p50_ms"], 2)
    assert final["full"]["summaries_done"] > 0 and final["full"]["summary_tok_s"] > 0
    assert launches == {"stem": 0, "vit_attention": 0, "quant_matmul": 0}


def test_cotenancy_tick_loop_order():
    """The NVR tick's order: detect issued, tracking, CLIP every 3rd tick,
    faces every 5th, <= steps_per_tick engine steps, then the boxes read
    back (``.cpu()``); finished summaries counted."""
    calls = []

    class Out:
        def cpu(self):
            calls.append("sync")

    class Req:
        def __init__(self):
            self.done, self.tokens = False, []

    class Engine:
        class engine:
            n_slots = 2

        def __init__(self):
            self.reqs = []

        def submit(self, frames, prompt, max_new):
            self.reqs.append(Req())
            return self.reqs[-1]

        def step(self):
            calls.append("step")
            for r in self.reqs:
                if not r.done:
                    r.done, r.tokens = True, [1, 2, 3]
                    return True
            return False

        def has_work(self):
            return False

    class Tracker:
        def update_all(self, dets, thresh):
            calls.append("track")

    x = torch.zeros((2, 1))
    lat, toks, done = tcot.tick_loop(
        lambda p, xx: calls.append("detect") or Out(), None, x,
        [[np.zeros((1, 6))] * 2] * 6, Tracker(), 6,
        clip_fn=lambda cx: calls.append("clip"), clip_x=None,
        face_fn=lambda fx: calls.append("face"), face_x=None,
        engine=Engine(), frames=[], steps_per_tick=2)
    assert len(lat) == 6 and done >= 2 and toks == 3 * done
    ticks, cur = [], []
    for c in calls:
        cur.append(c)
        if c == "sync":
            ticks.append(cur)
            cur = []
    assert ticks[0] == ["detect", "track", "clip", "face", "step", "step", "sync"]
    assert ticks[1][:2] == ["detect", "track"] and "clip" not in ticks[1]
    assert "clip" in ticks[3] and "face" in ticks[5] and "face" not in ticks[3]
    assert all(t[-1] == "sync" and t.count("step") <= 2 for t in ticks)


@pytest.mark.slow
def test_clip_tools_full_tower(capsys):
    """clip_bench and clip_probe as users run them, the full ViT-L/14 at
    batch 1 on the CPU."""
    rows = tbench.main(["--batches", "1", "--steps", "1", "--device", "cpu"])
    assert rows[0]["images_per_s"] > 0
    rows = tprobe.main(["--batches", "1", "--steps", "1", "--device", "cpu"])
    assert [r["stage"] for r in rows] == list(tprobe.STAGES)
    out = capsys.readouterr().out
    assert out.startswith("# device cpu")


# ---------------------------------------------------------------------------
# stem_probe, stem_kernel_probe, tunnel_probe
# ---------------------------------------------------------------------------

PROBE_ARGV = {"stem_probe": ["--batch", "2", "--res", "64", "--steps", "2"],
              "stem_kernel_probe": ["--batch", "2", "--res", "64", "--steps", "2"],
              "tunnel_probe": []}
# the JAX stem_kernel_probe's keys (stem_kernel_probe.py:89-96; its Pallas
# kernel does not run on the CPU outside interpret mode), the port's renames
SKP_RENAMES = {"batch": "batch", "xla_stem_ms": "cudnn_stem_ms",
               "pallas_stem_ms": "kernel_stem_ms",
               "s2d_layout_ms_unfused": "s2d_layout_ms_unfused",
               "speedup_vs_xla": "speedup_vs_cudnn", "max_abs_diff": "max_abs_diff"}


def _jax_probe_keys(tool, capsys) -> set:
    """The keys of the JSON line the JAX probe prints, run on the CPU."""
    if tool == "stem_kernel_probe":
        return set(SKP_RENAMES)
    if tool == "stem_probe":
        jsp.main(PROBE_ARGV[tool])
    else:
        jtunnel.main()
    keys = set(_json_lines(capsys.readouterr().out)[-1])
    keys.discard("async_err")       # the JAX tunnel_probe's caught error, if any
    return keys


@pytest.mark.parametrize("tool", sorted(PROBE_ARGV))
def test_probe_keys_on_the_cpu(tool, capsys):
    """Each probe at --device cpu prints the JAX probe's keys (with the
    renames its docstring maps) plus ``device``, every number finite; the
    card's line is a CPU line here."""
    want = _jax_probe_keys(tool, capsys)
    if tool == "stem_probe":
        want = want - {"mxu_ms_at_2.6pct_util"} | {"tensor_core_ms_at_peak"}
    elif tool == "stem_kernel_probe":
        want = {SKP_RENAMES[k] for k in want}
    n0 = tskp.S.stem.launches
    mod = {"stem_probe": tsp, "stem_kernel_probe": tskp, "tunnel_probe": ttunnel}[tool]
    res = mod.main(PROBE_ARGV[tool] + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert _json_lines(out) == [res]
    assert set(res) == want | {"device"} and res["device"] == "cpu"
    assert "# device: cpu (host numbers, not a card's)" in out.splitlines()
    nums = {k: v for k, v in res.items() if k not in ("device", "s2d_layout_ms_unfused")}
    assert all(isinstance(v, (int, float)) and np.isfinite(v) for v in nums.values()), res
    if tool == "stem_kernel_probe":
        assert res["s2d_layout_ms_unfused"] is None and res["max_abs_diff"] < 0.05
        assert f'# launches {{"stem": {n0}}}' in out     # the CPU route launches nothing
    if tool == "tunnel_probe":
        assert "# kernel launches a call: none on the CPU" in out


def test_tunnel_probe_options_and_refusal():
    """The JAX tunnel_probe takes no option; the port's takes --device only,
    and --device cuda (the default) raises without a GPU."""
    assert _options(_parser(ttunnel.main)) == {"--device": ("device", "cuda", None)}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            ttunnel.main([])


def test_stem_bounds_are_the_cards_at_the_defaults():
    """At [128,640,640,3] bf16: 524 MB over 3.35 TB/s, +839 MB with the
    intermediate's round trip, 41.5 GFLOP over the 989 TFLOP/s bf16 peak."""
    b = tsp.bounds(128, 640)
    assert b["roofline_ms_min_traffic"] == pytest.approx(524_288_000 / 3.35e12 * 1e3)
    assert b["roofline_ms_with_mid_roundtrip"] == pytest.approx(
        (524_288_000 + 838_860_800) / 3.35e12 * 1e3)
    assert b["stem_gflop"] == pytest.approx(41.5236, rel=1e-4)
    assert b["tensor_core_ms_at_peak"] == pytest.approx(41.5236e9 / 989e12 * 1e3, rel=1e-4)
    assert [round(b[k], 3) for k in ("roofline_ms_min_traffic", "roofline_ms_with_mid_roundtrip",
                                     "tensor_core_ms_at_peak")] == [0.157, 0.407, 0.042]


def test_probes_carry_no_tpu_constant():
    """Neither the v5e's 819 GB/s nor the MXU's 197 TFLOP/s at 2.6% is a
    rate of the port's probes."""
    for mod in (tsp, tskp, ttunnel):
        src = Path(mod.__file__).read_text()
        assert not any(c in src for c in ("819e9", "819 GB", "197e12", "0.026")), mod
