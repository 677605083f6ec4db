"""The port's BlazeFace, AdaFace and FacePipeline (clearcam_tpu_torch.models.
{blazeface,adaface,faces}) against the JAX package's, on the CPU, with the
same seeded numpy weights and inputs.

Random He-initialised BlazeFace weights blow activations up through 31
residual blocks (to ~1e8), so the detection comparisons scale its filters
by 0.5: activations stay O(1) and some scores clear the 0.85 floor. Both
packages get the same scaled weights."""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clearcam_tpu.models import adaface as jada
from clearcam_tpu.models import blazeface as jblaze
from clearcam_tpu.models.faces import FacePipeline as JaxFacePipeline
from clearcam_tpu.models.objects import ObjectFinder as JaxObjectFinder
from clearcam_tpu.tools.parity import synthetic_face
from clearcam_tpu_torch.models import adaface as tada
from clearcam_tpu_torch.models import blazeface as tblaze
from clearcam_tpu_torch.models.faces import FacePipeline
from clearcam_tpu_torch.models.objects import ObjectFinder
from clearcam_tpu_torch.testing import torch_threads

BOX_TOL = 1e-3      # px, 256-px space: f32 summation order through the net
EMB_TOL = 1e-4      # unit 512-d rows, f32


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    with torch_threads(2):
        yield


@pytest.fixture(scope="module")
def blaze():
    p = tblaze.init_params(seed=3)
    return {k: (v * 0.5 if v.ndim == 4 else v) for k, v in p.items()}


@pytest.fixture(scope="module")
def ada_mini():
    return tada.init_params(seed=1, blocks=tada.BLOCKS_MINI)


def _equal_dicts(mine, ref):
    assert mine.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(mine[k], np.asarray(ref[k]), err_msg=k)


def test_init_params_equal_jax():
    _equal_dicts(tblaze.init_params(seed=4), jblaze.init_params(seed=4))
    _equal_dicts(tada.init_params(seed=4, blocks=tada.BLOCKS_MINI),
                 jada.init_params(seed=4, blocks=jada.BLOCKS_MINI))
    np.testing.assert_array_equal(tblaze.default_anchors(), jblaze.default_anchors())


@pytest.mark.parametrize("mod", ["blazeface", "adaface"])
def test_convert_state_dict_matches_jax(mod):
    mine, ref = {"blazeface": (tblaze, jblaze), "adaface": (tada, jada)}[mod]
    rng = np.random.default_rng(5)
    sd = {"backbone.list.0.conv.weight": rng.standard_normal((8, 4, 3, 3), np.float32),
          "body.list.1.prelu_weight": rng.standard_normal(8).astype(np.float16),
          "anchors": rng.random((896, 4), np.float32),
          "head.list": rng.standard_normal((2, 3), np.float32)}
    got, want = mine.convert_state_dict(sd), ref.convert_state_dict(sd)
    assert set(got) == {"backbone.0.conv.weight", "body.1.prelu_weight",
                        "anchors", "head"}
    assert got["backbone.0.conv.weight"].shape == (3, 3, 4, 8)
    _equal_dicts(got, want)


def test_blazeface_forward_matches_jax(blaze):
    x = np.random.default_rng(6).uniform(-1, 1, (2, 256, 256, 3)).astype(np.float32)
    rj, sj = jblaze.forward(blaze, jnp.asarray(x))
    rt, st = tblaze.forward(tblaze.params_from_jax(blaze), torch.from_numpy(x))
    assert tuple(rt.shape) == (2, 896, 16) and tuple(st.shape) == (2, 896, 1)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-4, atol=1e-4)


def test_blazeface_decode_matches_jax_on_clusters(blaze):
    """Decode and NMS fed the same raw outputs: overlapping clusters of
    confident boxes (the chain rule), a tie in score, and scores under the
    floor."""
    rng = np.random.default_rng(7)
    raw = np.zeros((2, 896, 16), np.float32)
    raw[..., :2] = rng.normal(0, 4, (2, 896, 2))
    raw[..., 2:4] = rng.uniform(20, 60, (2, 896, 2))
    raw[..., 4:] = rng.normal(0, 10, (2, 896, 12))
    scores = rng.normal(0, 3, (2, 896, 1)).astype(np.float32)
    scores[0, 5, 0] = scores[0, 6, 0] = 8.0          # an exact tie
    p = tblaze.params_from_jax(blaze)
    ref = np.asarray(jblaze.decode(blaze, jnp.asarray(raw), jnp.asarray(scores)))
    got = tblaze.decode(p, torch.from_numpy(raw), torch.from_numpy(scores)).numpy()
    assert (ref[..., 16] > 0).sum() > 4
    np.testing.assert_array_equal(got[..., 16] > 0, ref[..., 16] > 0)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_blazeface_detect_matches_jax(blaze):
    img = np.random.default_rng(1).integers(0, 256, (256, 256, 3), np.uint8)
    ref = np.asarray(jblaze.detect(blaze, jnp.asarray(img)))
    got = tblaze.detect(tblaze.params_from_jax(blaze), torch.from_numpy(img)).numpy()
    live = ref[:, 16] > 0
    assert got.shape == (896, 17) and live.sum() > 0
    np.testing.assert_array_equal(got[:, 16] > 0, live)
    np.testing.assert_allclose(got[:, :16], ref[:, :16], rtol=0, atol=BOX_TOL)
    np.testing.assert_allclose(got[:, 16], ref[:, 16], rtol=0, atol=1e-5)


def test_adaface_mini_matches_jax(ada_mini):
    faces = np.random.default_rng(2).integers(0, 256, (3, 112, 112, 3), np.uint8)
    ref = np.asarray(jada.embed(ada_mini, jnp.asarray(faces)))
    got = tada.embed(tada.params_from_jax(ada_mini), torch.from_numpy(faces)).numpy()
    assert got.shape == (3, 512)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(got, ref, rtol=0, atol=EMB_TOL)


def test_face_pipeline_matches_jax(blaze, ada_mini, capsys):
    """The port's FacePipeline on given weights: detect_256 (host letterbox,
    device detect, map back), embed and embed_batch against the JAX one."""
    mine = FacePipeline("/nonexistent", blaze, ada_mini, device="cpu")
    ref = JaxFacePipeline("/nonexistent", blaze, ada_mini)
    img = np.random.default_rng(8).integers(0, 256, (300, 180, 3), np.uint8)
    got, want = mine.detect_256(img), ref.detect_256(img)
    assert (got is None) == (want is None)
    if got is not None:
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=0, atol=BOX_TOL * 300 / 256)
    faces = list(np.random.default_rng(9).integers(0, 256, (2, 112, 112, 3), np.uint8))
    np.testing.assert_allclose(mine.embed(faces[0]), ref.embed(faces[0]),
                               rtol=0, atol=EMB_TOL)
    np.testing.assert_allclose(mine.embed_batch(faces), ref.embed_batch(faces),
                               rtol=0, atol=EMB_TOL)


def test_face_pipeline_random_init_message(capsys, tmp_path, monkeypatch):
    """No weights anywhere: random init, with the JAX package's messages."""
    monkeypatch.setenv("CLEARCAM_REF_SNAPSHOT", str(tmp_path / "none"))
    monkeypatch.setattr(tada, "BLOCKS", tada.BLOCKS_MINI)
    pipe = FacePipeline(tmp_path, device="cpu")
    out = capsys.readouterr().out
    assert "blazeface weights not found" in out and "adaface weights not found" in out
    assert pipe.blaze_params["conv_tiny.weight"].device.type == "cpu"


def test_object_finder_face_ingest_matches_jax(tmp_path, blaze, ada_mini):
    """Face search through the shared ingest: person crops go through
    extract_face (stubbed to a fixed face here) and ONE embed_batch call,
    into faces/<day>/embeddings.pkl."""
    import cv2
    face = cv2.resize(synthetic_face(), (112, 112))     # smooth: JPEG keeps it
    crops = list(np.random.default_rng(11).integers(0, 256, (3, 150, 120, 3), np.uint8))
    mats = {}
    for name, finder in (("jax", JaxObjectFinder), ("torch", ObjectFinder)):
        base = tmp_path / name / "cameras"
        f = finder(base_dir=base, weights_dir=tmp_path,
                   **({"device": "cpu"} if name == "torch" else {}))
        f.init_face(blaze, ada_mini)
        f._face.extract_face = lambda img, face=face: face
        day = base / "cam1" / "objects" / "2026-10-16"
        day.mkdir(parents=True)
        paths = [day / f"{10 + i}_{i}_{0 if i < 2 else 2}.jpg" for i in range(3)]
        f.ingest_crops(paths, crops)
        assert f.load_all_embeddings(face=True) == 2          # person crops only
        mats[name] = f.face_index.matrix
        if name == "torch":
            assert isinstance(f._face, FacePipeline)
            # the saved face (a JPEG of the stub) finds both person crops
            res = f.search_image("cam1/faces/2026-10-16/10_0_0.jpg", is_face=True)
            assert len(res) == 2 and min(r[1] for r in res) > 0.99
    np.testing.assert_allclose(mats["torch"], mats["jax"], rtol=0, atol=EMB_TOL)


@pytest.mark.slow
def test_face_align_embed_e2e_golden():
    """The JAX package's golden (tests/make_face_golden.py): stubbed
    detection, real warp geometry, full 24-block IR-50 on seed 12, through
    the port. The crop is exact (shared host code); the embedding within
    EMB_TOL of the one XLA recorded."""
    import make_face_golden as g

    pipe = FacePipeline.__new__(FacePipeline)
    pipe.detect_256 = lambda padded: (g.BOX.copy(), g.LEFT_EYE.copy(),
                                      g.RIGHT_EYE.copy())
    crop = pipe.extract_face(synthetic_face())
    p = tada.params_from_jax(tada.init_params(seed=12))
    emb = tada.embed(p, torch.from_numpy(crop[None])).numpy()[0]
    with np.load(Path(__file__).parent / "fixtures" / "face_e2e_golden.npz") as z:
        np.testing.assert_array_equal(crop, z["crop"])
        np.testing.assert_allclose(emb, z["embedding"], rtol=0, atol=EMB_TOL)


@pytest.mark.slow
def test_ir50_full_depth_matches_jax():
    p = tada.init_params(seed=2)
    faces = np.random.default_rng(3).integers(0, 256, (2, 112, 112, 3), np.uint8)
    ref = np.asarray(jada.embed(p, jnp.asarray(faces)))
    got = tada.embed(tada.params_from_jax(p), torch.from_numpy(faces)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=EMB_TOL)
