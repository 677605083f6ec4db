"""The port's export, parity, clip_cli, viewer and fetch_weights tools on
the CPU, held against the JAX package's where both have the tool: the
exported detect
program replays equal to eager ``detect`` and to the JAX bundle's rows, in
a process that imports no model module; parity's checks skip missing files
and a golden recorded by either package passes the other's check; and the
tracing fault of the device-constant caches (a ``torch.export`` before any
eager call left FakeTensors in them) stays repaired. fetch_weights plans the
JAX tool's downloads and, with the JAX package blocked, extracts the same
ggml grids; nothing here touches the network."""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clearcam_tpu.models import yolov9 as J
from clearcam_tpu.tools import export as jexport
from clearcam_tpu.tools import fetch_weights as jfetch
from clearcam_tpu.tools import finetune as jfinetune
from clearcam_tpu.tools import parity as jparity
from clearcam_tpu_torch.cloud.crypto import encrypt_bytes, encrypt_file
from clearcam_tpu_torch.io import safetensors as st
from clearcam_tpu_torch.models import rfdetr
from clearcam_tpu_torch.models import yolov9 as T
from clearcam_tpu_torch.testing import compared_rows, detection_mismatches, torch_threads
from clearcam_tpu_torch.tools import clip_cli, parity
from clearcam_tpu_torch.tools import fetch_weights as tfetch
from clearcam_tpu_torch.tools import export as texport

from test_viewer import CLIP, KEY, relay  # noqa: F401  (the mock relay fixture)

cv2 = pytest.importorskip("cv2")
ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    with torch_threads(2):
        yield


FRAME_HW, RES = (240, 320), 320


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    """The port's bundle of YOLOv9-t at res 320 for 240x320 frames, and
    the seed-0 weights it holds."""
    params = T.init_params("t", seed=0)
    path = tmp_path_factory.mktemp("export") / "det.ccprog"
    meta = texport.export_detector(path, size="t", res=RES, frame_hw=FRAME_HW,
                                   batch=1, params=params, device="cpu")
    return path, meta, params


def _frames(seed=0):
    return np.random.default_rng(seed).integers(0, 255, (1, *FRAME_HW, 3), np.uint8)


def test_export_replays_equal_to_eager_and_to_the_jax_bundle(bundle, tmp_path):
    path, meta, params = bundle
    assert meta == {"version": 1, "size": "t", "res": RES, "input_shape": [1, *FRAME_HW, 3],
                    "output": "x1,y1,x2,y2,score,class rows", "device": "cpu"}
    rep = texport.Replayer(path, device="cpu")
    assert rep.meta == meta
    frames = _frames()
    out = rep(frames)
    with torch.no_grad():
        eager = T.detect(T.params_from_jax(params), torch.from_numpy(frames),
                         size="t", res=RES).numpy()
    np.testing.assert_array_equal(out, eager)
    jpath = tmp_path / "det_jax.ccprog"
    jexport.export_detector(jpath, size="t", res=RES, frame_hw=FRAME_HW, batch=1,
                            params=J.init_params("t", seed=0))
    ref = jexport.Replayer(jpath)(frames)
    assert detection_mismatches(ref, out) == []
    assert compared_rows(ref) > 0


def test_replay_process_imports_no_model_module(bundle):
    path, _, _ = bundle
    code = ("import sys, json, numpy as np\n"
            "sys.modules['jax'] = sys.modules['clearcam_tpu'] = None\n"
            "from clearcam_tpu_torch.tools.export import Replayer\n"
            f"rep = Replayer({str(path)!r}, device='cpu')\n"
            "out = rep(np.zeros(rep.meta['input_shape'], np.uint8))\n"
            "print(json.dumps({'shape': list(out.shape), 'modules': sorted(\n"
            "    m for m in sys.modules if m.startswith('clearcam_tpu_torch'))}))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT), capture_output=True,
                          text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.splitlines()[-1])
    assert got["shape"] == [1, 300, 6]
    assert "clearcam_tpu_torch.ops.stem" in got["modules"]
    assert not [m for m in got["modules"] if m.startswith("clearcam_tpu_torch.models")]


def test_export_before_any_eager_call_leaves_eager_detect_intact():
    """The anchors cache filled during a trace once held FakeTensors, and
    an eager detect afterwards returned one."""
    params = T.params_from_jax(T.init_params("dryrun", seed=0))
    frames = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (1, 96, 128, 3),
                                                               np.uint8))

    class Detect(torch.nn.Module):
        def forward(self, f):
            return T.detect(params, f, size="dryrun", res=64)

    with torch.no_grad():
        before = Detect()(frames)
        T._anchors_on.cache_clear()
        program = torch.export.export(Detect(), (frames,))
        after = Detect()(frames)
    assert type(after) is torch.Tensor and type(T._anchors_on(((2, 2),), torch.device("cpu"))[0]) \
        is torch.Tensor
    np.testing.assert_array_equal(after.numpy(), before.numpy())
    np.testing.assert_array_equal(program.module()(frames).numpy(), before.numpy())


def test_rfdetr_constant_tables_survive_export():
    boxes = torch.rand(2, 5, 4)
    ids = torch.tensor([1, 3, 90])

    class Consts(torch.nn.Module):
        def forward(self, b, i):
            return rfdetr.sine_box_embed(b, 8), rfdetr.remap_class_ids(i)

    before = Consts()(boxes, ids)
    rfdetr._on.cache_clear()
    rfdetr._freqs_on.cache_clear()
    torch.export.export(Consts(), (boxes, ids))
    after = Consts()(boxes, ids)
    for a, b in zip(after, before):
        assert type(a) is torch.Tensor
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_parity_run_skips_missing_files_and_strict_fails(tmp_path, capsys):
    w, f = tmp_path / "weights", tmp_path / "fixtures"
    assert parity.run(w, f, device="cpu") == 0
    lines = capsys.readouterr().out.splitlines()
    assert [x.split()[:2] for x in lines] == [[name, "SKIP"] for name in parity.CHECKS]
    assert parity.CHECKS.keys() == jparity.CHECKS.keys()
    assert parity.main(["run", "--weights", str(w), "--fixtures", str(f),
                        "--device", "cpu", "--strict"]) == 1
    assert "--strict: 8 skipped check(s) count as failures" in capsys.readouterr().out
    assert (parity.MOT_YOLO_EXPECTED, parity.MOT_RFDETR_EXPECTED) == (156, 157)


@pytest.fixture(scope="module")
def golden_dirs(tmp_path_factory):
    """Random-weight yolov9-t.safetensors in the published layout, and a
    240x320 image."""
    root = tmp_path_factory.mktemp("golden")
    (root / "weights").mkdir()
    jfinetune.save_published(T.init_params("t", seed=5), root / "weights" / "yolov9-t.safetensors")
    img = np.random.default_rng(3).integers(0, 256, (*FRAME_HW, 3), np.uint8)
    cv2.imwrite(str(root / "img.png"), img)
    return root


@pytest.mark.parametrize("recorder", ["jax", "port"])
def test_golden_of_either_package_passes_the_others_check(golden_dirs, tmp_path, recorder,
                                                         capsys):
    w, f = golden_dirs / "weights", tmp_path / "fixtures"
    f.mkdir()
    golden = f / "yolo_golden.npz"
    if recorder == "jax":
        jparity.record_golden(str(golden_dirs / "img.png"), str(golden), "t", 128, str(w))
        ok, msg = parity.check_yolo_golden(w, f, device="cpu")
    else:
        assert parity.main(["record-golden", str(golden_dirs / "img.png"), str(golden),
                            "--res", "128", "--weights", str(w), "--device", "cpu"]) == 0
        ok, msg = jparity.check_yolo_golden(w, f)
    with np.load(golden) as z:
        live = int((z["rows"][:, 4] > 0).sum())
        assert (str(z["size"]), int(z["res"])) == ("t", 128)
    assert ok is True, msg
    assert live > 0 and msg.startswith(f"{live} rows")
    if recorder == "port":
        assert parity.run(w, f, checks=["yolo"], device="cpu") == 0
        assert "yolo         PASS" in capsys.readouterr().out


def test_synthetic_face_equals_jax():
    np.testing.assert_array_equal(parity.synthetic_face(), jparity.synthetic_face())


def test_from_safetensors_matches_jax(golden_dirs):
    path = golden_dirs / "weights" / "yolov9-t.safetensors"
    frames = np.random.default_rng(4).integers(0, 256, (2, 96, 128, 3), np.uint8)
    ref = np.asarray(J.YOLOv9.from_safetensors(path, size="t", res=64)(jnp.asarray(frames)))
    got = T.YOLOv9.from_safetensors(path, size="t", res=64, device="cpu")(frames).numpy()
    assert detection_mismatches(ref, got) == []


def test_clip_cli_decrypt_and_inspect(tmp_path, capsys):
    src = tmp_path / "clip.mp4"
    src.write_bytes(b"\x00\x00\x00\x18ftypmp42" + bytes(range(256)) * 8)
    enc = tmp_path / "clip.mp4.aes"
    assert encrypt_file(src, enc, "sekrit")
    out = tmp_path / "out.mp4"
    with pytest.raises(SystemExit) as e:
        clip_cli.main(["decrypt", str(enc), str(out), "--key", "sekrit"])
    assert e.value.code == 0 and out.read_bytes() == src.read_bytes()
    with pytest.raises(SystemExit) as e:
        clip_cli.main(["decrypt", str(enc), str(tmp_path / "bad.mp4"), "--key", "wrong"])
    assert e.value.code == 1
    capsys.readouterr()
    p = tmp_path / "w.safetensors"
    st.save({"tower.w": np.zeros((3, 4), np.float32), "tower.b": np.ones((4,), np.float32)}, p)
    clip_cli.main(["inspect", str(p)])
    text = capsys.readouterr().out
    assert "tower.w: [3, 4] F32" in text and "2 tensors" in text


def test_viewer_flows(relay, tmp_path):  # noqa: F811
    from clearcam_tpu_torch.cloud.viewer import ViewerClient
    c = ViewerClient("tok", base_url=relay)
    assert c.ping() and c.validate_user()
    assert c.list_devices()[0]["name"] == "porch"
    assert c.fetch_live_segment("porch", KEY) == CLIP
    events = c.list_events()
    assert len(events) == 1 and c.list_events(newest_creation_time=100) == []
    out = tmp_path / "event.mp4"
    assert c.download_event(events[0], KEY, dst=out) == CLIP and out.read_bytes() == CLIP
    with pytest.raises(ValueError):
        c.download_event(events[0], "badkey")
    assert not ViewerClient("wrong", base_url=relay).validate_user()
    assert encrypt_bytes(CLIP, KEY) != CLIP


# ---------------------------------------------------------------------------
# fetch_weights
# ---------------------------------------------------------------------------

@pytest.fixture
def no_network(monkeypatch):
    """urlopen of anything but a file:// URL fails the test."""
    import urllib.request
    real = urllib.request.urlopen

    def local_only(url, *a, **k):
        assert str(getattr(url, "full_url", url)).startswith("file://"), url
        return real(url, *a, **k)
    monkeypatch.setattr(urllib.request, "urlopen", local_only)


@pytest.mark.parametrize("group", sorted(jfetch.URLS) + ["all"])
def test_fetch_plan_is_the_jax_tools(group, tmp_path):
    """Every model group plans the JAX tool's URL candidates into the same
    destinations."""
    assert tfetch.URLS.keys() == jfetch.URLS.keys()
    models = list(jfetch.URLS) if group == "all" else [group]
    args = (models, tmp_path / "w", tmp_path / "f", ["t", "s", "e"], 4)
    assert tfetch.plan(*args) == jfetch.plan(*args) != []


def test_fetch_dry_run_touches_nothing(tmp_path, capsys, no_network):
    argv = ["--dest", str(tmp_path / "w"), "--fixtures", str(tmp_path / "f"),
            "--models", "all", "--yolo-sizes", "t", "s", "--dry-run"]
    out = []
    for tool in (tfetch, jfetch):
        with pytest.raises(SystemExit) as e:
            tool.main(argv)
        assert e.value.code == 0
        out.append(capsys.readouterr().out)
    assert list(tmp_path.iterdir()) == []
    assert out[0] == out[1] and out[0].count("would fetch") == 11


def test_fetch_copies_a_file_url_and_leaves_no_part_file(tmp_path, capsys, no_network):
    src = tmp_path / "src.bin"
    src.write_bytes(bytes(range(256)) * 5000)
    dest = tmp_path / "w" / "model.safetensors"
    dest.parent.mkdir()
    missing = (tmp_path / "missing.bin").as_uri()
    assert not tfetch.fetch([missing], dest)
    assert "FAILED" in capsys.readouterr().out and list(dest.parent.iterdir()) == []
    assert tfetch.fetch([missing, src.as_uri()], dest)
    assert dest.read_bytes() == src.read_bytes() and list(dest.parent.iterdir()) == [dest]
    assert tfetch.fetch([missing], dest)
    assert "already present" in capsys.readouterr().out


_GRIDS = r"""
import sys
sys.modules["jax"] = None
sys.modules["clearcam_tpu"] = None
from clearcam_tpu_torch.tools import fetch_weights
try:
    fetch_weights.main(sys.argv[1:])
finally:
    loaded = [m for m in sys.modules if sys.modules[m] is not None
              and m.split(".")[0] in ("jax", "clearcam_tpu")]
    assert not loaded, loaded
"""


def _ggml_header(rng) -> str:
    """A ggml-common.h of random tables in GGML_TABLE_BEGIN form
    (tests/test_gguf_iq.py's synthetic header)."""
    from clearcam_tpu_torch.io.ggml_grids import GRID_SPECS
    lines = []
    for name, (_, n, nb) in GRID_SPECS.items():
        vals = rng.integers(0, 1 << (8 * nb), n, np.uint64)
        ctype = "uint32_t" if nb == 4 else "uint64_t"
        lines.append(f"GGML_TABLE_BEGIN({ctype}, {name}, {n})\n"
                     + ", ".join(f"0x{v:x}" for v in vals) + ",\nGGML_TABLE_END()\n")
    return "\n".join(lines)


def test_fetch_ggml_grids_with_the_jax_package_blocked(tmp_path):
    """--models ggml-grids on a header already in --dest, in a process where
    jax and the JAX package cannot be imported, writes the npz the repo's
    tools/extract_ggml_grids.py writes, array for array."""
    import importlib.util
    spec = importlib.util.spec_from_file_location("extract_ggml_grids",
                                                  ROOT / "tools" / "extract_ggml_grids.py")
    ref_tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref_tool)
    text = _ggml_header(np.random.default_rng(0))
    dest = tmp_path / "w"
    dest.mkdir()
    (dest / "ggml-common.h").write_text(text)
    ref_tool.extract_to_npz(text, tmp_path / "ref.npz")
    proc = subprocess.run(
        [sys.executable, "-c", _GRIDS, "--dest", str(dest), "--fixtures",
         str(tmp_path / "f"), "--models", "ggml-grids"],
        cwd=str(ROOT), env=dict(os.environ, PYTHONPATH=str(ROOT)),
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-3000:]
    assert "ggml-common.h: already present" in proc.stdout
    with np.load(dest / "ggml_grids.npz") as got, np.load(tmp_path / "ref.npz") as ref:
        assert sorted(got.files) == sorted(ref.files) == sorted(
            ["iq3xxs_grid", "iq3s_grid", "iq2s_grid"])
        for name in ref.files:
            assert got[name].dtype == ref[name].dtype
            np.testing.assert_array_equal(got[name], ref[name])


def test_fetch_ggml_grids_reports_a_bad_header(tmp_path, capsys):
    """A header without the tables fails the run (exit 1) and writes no npz."""
    dest = tmp_path / "w"
    dest.mkdir()
    (dest / "ggml-common.h").write_text("/* no tables */\n")
    with pytest.raises(SystemExit) as e:
        tfetch.main(["--dest", str(dest), "--fixtures", str(tmp_path / "f"),
                     "--models", "ggml-grids"])
    assert e.value.code == 1 and not (dest / "ggml_grids.npz").exists()
    assert "extraction FAILED (could not extract iq3xxs_grid" in capsys.readouterr().out
