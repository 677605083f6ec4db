"""The port's RF-DETR (clearcam_tpu_torch.models.rfdetr) against the JAX
package's, on the CPU in float32, at tests/test_rfdetr.py's TINY config:
the same numpy weights from init_params (carried across by params_from_jax)
and the same numpy inputs, module by module and through the whole forward
and detect. Bounds: 1e-5 per module, 1e-4 for the forward's logits and
boxes, the proposal index sets equal, detect rows under
clearcam_tpu_torch.testing's rule. Nano at its published widths is in the
slow tier."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as tF

from clearcam_tpu.models import rfdetr as J
from clearcam_tpu_torch.models import rfdetr as T
from clearcam_tpu_torch.nn import functional as F
from clearcam_tpu_torch.testing import compared_rows, detection_mismatches, torch_threads

from test_rfdetr import TINY

TINY_T = T.RFDETRConfig(**dataclasses.asdict(TINY))
MODULE_TOL = 1e-5
FORWARD_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    with torch_threads(2):
        yield


@pytest.fixture(scope="module")
def tiny():
    """(JAX params, port params, normalized input [2,64,64,3])."""
    jp = J.init_params(TINY, seed=0)
    x = np.random.default_rng(4).normal(size=(2, TINY.resolution, TINY.resolution, 3))
    return jp, T.params_from_jax(jp), x.astype(np.float32)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _gap(a, b) -> float:
    return float(np.abs(_np(a).astype(np.float64) - _np(b)).max())


def _jax_proposals(jp, x, cfg):
    """The JAX forward's two-stage selection (rfdetr.py:431-440), spelled out
    to read its top-k indices."""
    taps, hw = J.backbone_forward(jp, jnp.asarray(x), cfg)
    memory_map = J.projector_forward(jp, taps, hw, cfg)
    mem = memory_map.reshape(memory_map.shape[0], -1, cfg.d_model)
    enc = J.F.layer_norm_p(jp, "enc_norm", J.F.linear_p(jp, "enc_output", mem))
    scores = jax.nn.sigmoid(J.F.linear_p(jp, "enc_class", enc)).max(-1)
    return np.asarray(jax.lax.top_k(scores, cfg.num_queries)[1])


def _port_proposals(tp, x, cfg):
    """The port's proposal indices for x, through the same stages."""
    taps, hw = T.backbone_forward(tp, torch.from_numpy(x), cfg)
    return T.proposals(tp, T.projector_forward(tp, taps, hw, cfg), cfg)[1].numpy()


# ---------------------------------------------------------------------------
# parameters, remap, postprocess
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["nano", "tiny"])
def test_init_params_equal_jax(variant):
    cfg_j, cfg_t = (TINY, TINY_T) if variant == "tiny" else ("nano", "nano")
    ref, got = J.init_params(cfg_j, seed=3), T.init_params(cfg_t, seed=3)
    assert list(ref) == list(got)
    for k in ref:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], np.asarray(ref[k]), err_msg=k)
    assert T.VARIANTS.keys() == J.VARIANTS.keys()
    assert all(dataclasses.asdict(T.VARIANTS[v]) == dataclasses.asdict(J.VARIANTS[v])
               for v in J.VARIANTS)


def test_remap_matches_jax():
    assert T.detr_to_yolo == J.detr_to_yolo and len(T.detr_to_yolo) == 80
    ids = [1, 12, 3, 91, 90, 0, 45]
    assert T.remap_class_ids(ids).tolist() == np.asarray(J.remap_class_ids(ids)).tolist()
    assert T.remap_class_ids([1, 12, 3, 91]).tolist() == [0, -1, 2, -1]


@pytest.mark.parametrize("use_sigmoid", [False, True])
def test_postprocess_matches_jax(use_sigmoid):
    """Both scoring modes on random logits with planted confident queries,
    a background winner and a gap class; ties in score go to the lower
    query index, as jax.lax.top_k orders them."""
    rng = np.random.default_rng(7)
    b, q, c = 2, 40, 92
    logits = rng.normal(0, 2, (b, q, c)).astype(np.float32)
    logits[:, 0, 1] = 10.0                 # confident person
    logits[:, 1, 91] = 12.0                # background (softmax mode)
    logits[:, 2, 12] = 11.0                # gap id 12 (street sign)
    logits[:, 5] = logits[:, 3]            # an exact score tie
    boxes = rng.uniform(0.1, 0.9, (b, q, 4)).astype(np.float32)
    for max_det in (q, 10):
        kw = dict(conf_threshold=0.5, max_det=max_det, use_sigmoid=use_sigmoid)
        ref = np.asarray(J.detr_postprocess(jnp.asarray(logits), jnp.asarray(boxes),
                                            (100, 200), **kw))
        got = T.detr_postprocess(torch.from_numpy(logits), torch.from_numpy(boxes),
                                 (100, 200), **kw).numpy()
        assert got.shape == ref.shape == (b, max_det, 6)
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-4)
    # the JAX test's decoded box (tests/test_rfdetr.py:44-58)
    lg = np.full((1, 5, 92), -10.0, np.float32)
    bx = np.zeros((1, 5, 4), np.float32)
    lg[0, 0, 1] = 10.0
    bx[0, 0] = [0.5, 0.5, 0.2, 0.4]
    lg[0, 1, 91] = 10.0
    lg[0, 2, 12] = 10.0
    out = T.detr_postprocess(torch.from_numpy(lg), torch.from_numpy(bx), (100, 200))[0]
    live = out[out[:, 4] > 0].numpy()
    assert live.shape[0] == 1 and live[0, 5] == 0 and live[0, 4] > 0.9
    np.testing.assert_allclose(live[0, :4], [80.0, 30.0, 120.0, 70.0], rtol=1e-5)


def test_top_k_breaks_ties_like_jax():
    s = np.array([[0.5, 0.9, 0.5, 0.1, 0.9, 0.5]], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(s), 4)
    tv, ti = T.top_k(torch.from_numpy(s), 4)
    assert ti.tolist() == np.asarray(ji).tolist() == [[1, 4, 0, 2]]
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

def test_windows_roundtrip_matches_jax():
    x = np.random.default_rng(0).normal(size=(2, 8 * 8, 5)).astype(np.float32)
    w = T._to_windows(torch.from_numpy(x), (8, 8), 2)
    assert w.shape == (2 * 4, 16, 5)
    np.testing.assert_array_equal(w.numpy(), np.asarray(J._to_windows(jnp.asarray(x), (8, 8), 2)))
    np.testing.assert_array_equal(T._from_windows(w, (8, 8), 2, 2).numpy(), x)


def test_bilinear_sample_matches_jax_and_grid_sample():
    """Zero padding at half-pixel centres, locations past every border."""
    rng = np.random.default_rng(1)
    vmap = rng.normal(size=(2, 6, 9, 4)).astype(np.float32)
    loc = rng.uniform(-0.1, 1.1, (2, 25, 2)).astype(np.float32)
    got = T.bilinear_sample(torch.from_numpy(vmap), torch.from_numpy(loc)).numpy()
    ref = np.asarray(J.bilinear_sample(jnp.asarray(vmap), jnp.asarray(loc)))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    grid = torch.from_numpy(loc * 2 - 1).reshape(2, 25, 1, 2)
    gs = tF.grid_sample(torch.from_numpy(vmap).permute(0, 3, 1, 2), grid, mode="bilinear",
                        padding_mode="zeros", align_corners=False)
    np.testing.assert_allclose(got, gs.squeeze(-1).permute(0, 2, 1).numpy(),
                               rtol=1e-6, atol=1e-7)


def test_deformable_attention_matches_jax():
    cfg = TINY
    jp = J.init_params(cfg, seed=3)
    tp = T.params_from_jax(jp)
    rng = np.random.default_rng(2)
    b, q, d = 2, cfg.num_queries, cfg.d_model
    hh = ww = cfg.resolution // cfg.patch_size
    query = rng.normal(size=(b, q, d)).astype(np.float32)
    vmap = rng.normal(size=(b, hh, ww, d)).astype(np.float32)
    refs = rng.uniform(0.2, 0.8, (b, q, 4)).astype(np.float32)
    pre = "decoder.layers.0.cross_attn"
    ref = J.deformable_attention(jp, pre, jnp.asarray(query), jnp.asarray(vmap),
                                 jnp.asarray(refs), cfg)
    got = T.deformable_attention(tp, pre, torch.from_numpy(query), torch.from_numpy(vmap),
                                 torch.from_numpy(refs), TINY_T)
    assert _gap(got, ref) <= MODULE_TOL


@pytest.mark.parametrize("stage", ["backbone", "projector", "decoder"])
def test_modules_match_jax(tiny, stage):
    """Each stage on the JAX stage's own inputs."""
    jp, tp, x = tiny
    jtaps, hw = J.backbone_forward(jp, jnp.asarray(x), TINY)
    if stage == "backbone":
        ttaps, thw = T.backbone_forward(tp, torch.from_numpy(x), TINY_T)
        assert thw == hw and len(ttaps) == len(jtaps) == len(TINY.out_blocks)
        for a, b in zip(ttaps, jtaps):
            assert _gap(a, b) <= MODULE_TOL
        return
    jmap = J.projector_forward(jp, jtaps, hw, TINY)
    if stage == "projector":
        got = T.projector_forward(tp, [torch.from_numpy(np.array(t)) for t in jtaps],
                                  hw, TINY_T)
        assert got.shape == (2, *hw, TINY.d_model)
        assert _gap(got, jmap) <= MODULE_TOL
        return
    rng = np.random.default_rng(5)
    refs = rng.uniform(0.2, 0.8, (2, TINY.num_queries, 4)).astype(np.float32)
    tgt = rng.normal(0, 1, (2, TINY.num_queries, TINY.d_model)).astype(np.float32)
    jt, jb = J.decoder_forward(jp, jmap, jnp.asarray(refs), jnp.asarray(tgt), TINY)
    tt, tb = T.decoder_forward(tp, torch.from_numpy(np.array(jmap)), torch.from_numpy(refs),
                               torch.from_numpy(tgt), TINY_T)
    assert _gap(tt, jt) <= MODULE_TOL and _gap(tb, jb) <= MODULE_TOL


def test_sine_box_embed_matches_jax():
    boxes = np.random.default_rng(6).uniform(0, 1, (2, 7, 4)).astype(np.float32)
    ref = J.sine_box_embed(jnp.asarray(boxes), 16)
    got = T.sine_box_embed(torch.from_numpy(boxes), 16)
    assert got.shape == (2, 7, 64) and _gap(got, ref) <= MODULE_TOL


def test_backbone_mlp_gelu_is_jax_tanh(tiny, monkeypatch):
    """jax.nn.gelu defaults to the tanh approximation: the port's backbone
    matches the JAX one with it, and moves far past the bound with torch's
    exact (erf) GELU in its place."""
    jp, tp, x = tiny
    z = torch.linspace(-4, 4, 101)
    np.testing.assert_allclose(T.gelu(z).numpy(), np.asarray(jax.nn.gelu(jnp.asarray(z.numpy()))),
                               rtol=1e-6, atol=1e-6)
    jtaps, _ = J.backbone_forward(jp, jnp.asarray(x), TINY)
    ttaps, _ = T.backbone_forward(tp, torch.from_numpy(x), TINY_T)
    assert max(_gap(a, b) for a, b in zip(ttaps, jtaps)) <= MODULE_TOL
    monkeypatch.setattr(T, "gelu", lambda v: tF.gelu(v, approximate="none"))
    etaps, _ = T.backbone_forward(tp, torch.from_numpy(x), TINY_T)
    assert max(_gap(a, b) for a, b in zip(etaps, jtaps)) > 10 * MODULE_TOL


# ---------------------------------------------------------------------------
# the whole forward and detect
# ---------------------------------------------------------------------------

def test_forward_matches_jax(tiny):
    jp, tp, x = tiny
    jl, jb = J.forward(jp, jnp.asarray(x), TINY)
    tl, tb = T.forward(tp, torch.from_numpy(x), TINY_T)
    assert tl.shape == (2, TINY.num_queries, TINY.num_classes)
    assert _gap(tl, jl) <= FORWARD_TOL and _gap(tb, jb) <= FORWARD_TOL
    top, ref_top = _port_proposals(tp, x, TINY_T), _jax_proposals(jp, x, TINY)
    assert [sorted(r) for r in top.tolist()] == [sorted(r) for r in ref_top.tolist()]
    np.testing.assert_array_equal(top, ref_top)     # and in the same order
    bx = tb.numpy()
    assert np.isfinite(tl.numpy()).all() and (bx >= 0).all() and (bx <= 1).all()


@pytest.mark.parametrize("conf", [0.5, 0.0])
def test_detect_rows_match_jax(tiny, conf):
    """Letterbox on a square canvas (auto=False), then source pixels."""
    jp, tp, _ = tiny
    frames = np.random.default_rng(8).integers(0, 255, (2, 96, 128, 3), np.uint8)
    ref = np.asarray(J.detect(jp, jnp.asarray(frames), cfg=TINY, conf_threshold=conf))
    got = T.detect(tp, torch.from_numpy(frames), cfg=TINY_T, conf_threshold=conf).numpy()
    assert got.shape == ref.shape == (2, TINY.num_queries, 6)
    assert detection_mismatches(ref, got, conf_threshold=conf) == []
    assert compared_rows(ref, conf_threshold=conf) > 0
    np.testing.assert_allclose(
        T.preprocess(torch.from_numpy(frames), TINY.resolution).numpy(),
        np.asarray(J.preprocess(jnp.asarray(frames), TINY.resolution)), atol=1e-5)


def test_convert_state_dict_matches_jax():
    """The JAX converter's prefixes, drops and patch-embed transpose; every
    other 4-D filter (the projector's convs) goes to HWIO as well, where the
    JAX converter passes the torch OIHW layout through."""
    rng = np.random.default_rng(9)
    sd = {"model.backbone.patch_embed.weight": rng.normal(size=(8, 3, 4, 4)),
          "module.class_head.weight": rng.normal(size=(91, 32)),
          "ema.decoder.norm.bias": rng.normal(size=(32,)),
          "model.projector.m.0.cv1.conv.weight": rng.normal(size=(6, 5, 3, 3)),
          "model.dn_embed.weight": np.zeros((5, 5)),
          "model.label_enc.weight": np.zeros((5, 5))}
    ref, got = J.convert_state_dict(sd), T.convert_state_dict(sd)
    assert sorted(got) == sorted(ref) == [
        "backbone.patch_embed.weight", "class_head.weight", "decoder.norm.bias",
        "projector.m.0.cv1.conv.weight"]
    assert got["backbone.patch_embed.weight"].shape == (4, 4, 3, 8)
    for k in ref:
        assert got[k].dtype == np.float32
        if k.startswith("projector"):
            assert np.asarray(ref[k]).shape == (6, 5, 3, 3)      # the JAX fault
            np.testing.assert_array_equal(got[k], F.oihw_to_hwio(np.asarray(ref[k])))
        else:
            np.testing.assert_array_equal(got[k], np.asarray(ref[k]))


def test_from_checkpoint_loads_a_torch_state_dict(tmp_path):
    sd = {f"model.{k}": torch.from_numpy(F.hwio_to_oihw(v) if v.ndim == 4 else v)
          for k, v in T.init_params(TINY_T, seed=2).items()}
    sd["model.dn_embed.weight"] = torch.zeros(3, 3)
    path = tmp_path / "rf.pth"
    torch.save({"model": sd}, path)
    det = T.RFDETR.from_checkpoint(str(path), TINY_T, device="cpu")
    ref = T.RFDETR(TINY_T, params=T.init_params(TINY_T, seed=2), device="cpu")
    frame = np.random.default_rng(3).integers(0, 255, (96, 128, 3), np.uint8)
    np.testing.assert_array_equal(det(frame).numpy(), ref(frame).numpy())


def test_rfdetr_detect_many_feeds_ocsort():
    from clearcam_tpu_torch.track.ocsort import OCSort
    det = T.RFDETR(TINY_T, conf_threshold=0.0, device="cpu")
    frame = np.zeros((96, 128, 3), np.uint8)
    assert det(frame).shape == (TINY.num_queries, 6)
    outs = det.detect_many([frame, frame])
    assert len(outs) == 2 and outs[0].shape == (TINY.num_queries, 6)
    np.testing.assert_array_equal(outs[0], outs[1])
    trk = OCSort()
    for _ in range(3):
        tracks = trk.update(outs[0][:8], 0.0)
    assert tracks and all(t.class_id >= 0 for t in tracks)


def test_detr_detector_plugs_into_tracker():
    from clearcam_tpu_torch.track.ocsort import OCSort

    def fake_query(frames):
        b = frames.shape[0]
        logits = torch.full((b, 3, 92), -10.0)
        logits[:, 0, 1] = 10.0
        boxes = torch.zeros((b, 3, 4))
        boxes[:, 0] = torch.tensor([0.5, 0.5, 0.3, 0.3])
        return logits, boxes

    det = T.DETRDetector(fake_query, (240, 320), device="cpu")
    trk = OCSort()
    for _ in range(5):
        rows = det.detect_many([np.zeros((240, 320, 3), np.uint8)])[0]
        tracks = trk.update(rows, 0.25)
    assert tracks and int(tracks[0].class_id) == 0


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default does not raise")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        T.RFDETR(TINY_T)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        T.DETRDetector(lambda f: None, (10, 10))


@pytest.mark.slow
def test_nano_forward_matches_jax():
    """Nano at its published widths (res 384, 12 ViT blocks of 192, 300
    queries) on one random 1080p frame: logits and boxes within the
    forward's bound, the proposals equal, detect rows under the rule."""
    jp = J.init_params("nano", seed=0)
    tp = T.params_from_jax(jp)
    cfg = J.VARIANTS["nano"]
    frames = np.random.default_rng(0).integers(0, 255, (1, 1080, 1920, 3), np.uint8)
    x = np.asarray(J.preprocess(jnp.asarray(frames), cfg.resolution))
    jl, jb = J.forward(jp, jnp.asarray(x), cfg)
    tl, tb = T.forward(tp, torch.from_numpy(x), T.VARIANTS["nano"])
    assert _gap(tl, jl) <= FORWARD_TOL and _gap(tb, jb) <= FORWARD_TOL
    np.testing.assert_array_equal(_port_proposals(tp, x, T.VARIANTS["nano"]),
                                  _jax_proposals(jp, x, cfg))
    ref = np.asarray(J.detect(jp, jnp.asarray(frames), cfg=cfg))
    got = T.detect(tp, torch.from_numpy(frames), cfg=T.VARIANTS["nano"]).numpy()
    assert detection_mismatches(ref, got, conf_threshold=0.5) == []
