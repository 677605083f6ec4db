"""The port's CLIP towers (clearcam_tpu_torch.models.clip) and its
ObjectFinder against the JAX package's, on the CPU, with the same seeded
numpy weights and inputs. Two image and two text blocks at full width here;
the full 24 + 12 blocks in the slow tier. Tolerance: f32 max |d| <= 1e-4 on
unit rows (summation order over 1024-wide products)."""
import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clearcam_tpu.models import clip as jclip
from clearcam_tpu.models.objects import ObjectFinder as JaxObjectFinder
from clearcam_tpu_torch.models import clip as tclip
from clearcam_tpu_torch.models import objects as tobjects
from clearcam_tpu_torch.models.objects import ObjectFinder
from clearcam_tpu_torch.ops import vit_attention as tattn
from clearcam_tpu_torch.testing import torch_threads
from test_clip_and_search import tiny_tokenizer

TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    with torch_threads(2):
        yield


@pytest.fixture(scope="module")
def params():
    """(numpy params of the port, JAX params), 2 + 2 blocks, seed 0."""
    return (tclip.init_params(seed=0, img_blocks=2, txt_blocks=2),
            jclip.init_params(seed=0, img_blocks=2, txt_blocks=2))


def _tokens():
    toks = np.zeros((3, 77), np.int32)
    toks[0, :3] = [49406, 100, 49407]
    toks[1, :2] = [49406, 49407]
    toks[2, :6] = [49406, 320, 1929, 530, 2300, 49407]
    return toks


def test_init_params_equal_jax(params):
    mine, ref = params
    assert mine.keys() == ref.keys()
    for k in ref:
        assert mine[k].dtype == np.float32
        np.testing.assert_array_equal(mine[k], np.asarray(ref[k]), err_msg=k)


def test_convert_state_dict_matches_jax():
    rng = np.random.default_rng(1)
    sd = {"visual_conv1.weight": rng.standard_normal((8, 3, 14, 14), np.float32),
          "proj": rng.standard_normal((8, 6), np.float32),
          "resblocks.0.in_proj_weight": rng.standard_normal((12, 4)).astype(np.float16),
          "attn_mask": np.zeros((77, 77), np.float32),
          "resblocks.0.attn_mask": np.zeros((77, 77), np.float32)}
    mine = tclip.convert_state_dict(sd)
    ref = jclip.convert_state_dict(sd)
    assert mine.keys() == ref.keys() == {"visual_conv1.weight", "proj",
                                         "resblocks.0.in_proj_weight"}
    assert mine["visual_conv1.weight"].shape == (14, 14, 3, 8)
    for k in ref:
        assert mine[k].dtype == np.float32
        np.testing.assert_array_equal(mine[k], np.asarray(ref[k]))


def test_params_from_jax_patch_matrix(params):
    """The HWIO patch filter becomes a (1024, 588) matrix whose product with
    a patch is the convolution's output at that patch."""
    p = tclip.params_from_jax(params[0], "cpu")
    w = p[tclip.PATCH_KEY]
    assert tuple(w.shape) == (1024, 14 * 14 * 3)
    x = np.random.default_rng(2).uniform(-1, 1, (1, 224, 224, 3)).astype(np.float32)
    patch = tclip.patchify(torch.from_numpy(x))[0, 17]        # row 1, col 1
    direct = np.einsum("hwc,hwco->o", x[0, 14:28, 14:28], params[0][tclip.PATCH_KEY])
    np.testing.assert_allclose((w @ patch).numpy(), direct, rtol=0, atol=1e-4)


@pytest.mark.parametrize("flash", [False, None])
def test_encode_image_matches_jax(params, flash):
    """flash=None on the CPU takes the plain route; the kernel is not
    launched."""
    px = np.random.default_rng(3).integers(0, 256, (2, 224, 224, 3), np.uint8)
    ref = np.asarray(jclip.encode_image(params[1], jnp.asarray(px), flash=False))
    before = tattn.mha_flash.launches
    got = tclip.encode_image(tclip.params_from_jax(params[0], "cpu"),
                             torch.from_numpy(px), flash=flash).numpy()
    assert tattn.mha_flash.launches == before
    assert got.shape == (2, 768)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)


def test_encode_text_matches_jax(params):
    toks = _tokens()
    ref = np.asarray(jclip.encode_text(params[1], jnp.asarray(toks)))
    got = tclip.encode_text(tclip.params_from_jax(params[0], "cpu"),
                            torch.from_numpy(toks)).numpy()
    assert got.shape == (3, 768)
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)


def test_clip_module(params):
    m = tclip.CLIP(params[0], device="cpu")
    px = np.random.default_rng(4).integers(0, 256, (1, 224, 224, 3), np.uint8)
    flat = tclip.params_from_jax(params[0], "cpu")
    torch.testing.assert_close(m(torch.from_numpy(px)),
                               tclip.encode_image(flat, torch.from_numpy(px)))
    torch.testing.assert_close(m.encode_text(torch.from_numpy(_tokens())),
                               tclip.encode_text(flat, torch.from_numpy(_tokens())))


def _crops(day_dir, n):
    """Random crops written as the NVR writes them, and read back as
    NVR._drain_object_queue hands them to ingest_crops (RGB from the JPEG)."""
    day_dir.mkdir(parents=True)
    rng = np.random.default_rng(5)
    paths, imgs = [], []
    for i in range(n):
        h, w = rng.integers(40, 200, 2)
        path = day_dir / f"{10 + i}_{i}_{i % 2}.jpg"
        cv2.imwrite(str(path), rng.integers(0, 256, (h, w, 3), np.uint8))
        paths.append(path)
        imgs.append(cv2.cvtColor(cv2.imread(str(path)), cv2.COLOR_BGR2RGB))
    return paths, imgs


def test_object_finder_ingest_and_search_match_jax(tmp_path, params):
    """ingest_crops -> load_all_embeddings -> search_image: the port's
    finder stores the JAX finder's embeddings and returns its ranking, the
    crop itself first."""
    finders = {}
    for name, finder, p in (("jax", JaxObjectFinder, params[1]),
                            ("torch", ObjectFinder, params[0])):
        base = tmp_path / name / "cameras"
        kw = {"device": "cpu"} if name == "torch" else {}
        f = finder(base_dir=base, weights_dir=tmp_path, **kw)
        f.init_clip(params=p)
        paths, imgs = _crops(base / "cam1" / "objects" / "2026-10-16", 5)
        f.ingest_crops(paths, imgs)
        assert f.load_all_embeddings() == 5
        finders[name] = f
    jf, tf = finders["jax"], finders["torch"]
    assert tf.clip_dtype == torch.float32 and tf.kernel_library is None
    assert [p.split("/torch/")[1] for p in tf.index.paths] == \
        [p.split("/jax/")[1] for p in jf.index.paths]
    np.testing.assert_allclose(tf.index.matrix, jf.index.matrix, rtol=0, atol=TOL)
    for i, rel in enumerate(["cam1/objects/2026-10-16/11_1_1.jpg",
                             "cam1/objects/2026-10-16/13_3_1.jpg"]):
        got = tf.search_image(rel, top_k=5)
        ref = jf.search_image(rel, top_k=5)
        assert got[0][0].endswith(rel) and abs(got[0][1] - 1.0) < 1e-5
        assert [g[0].split("/torch/")[1] for g in got] == \
            [r[0].split("/jax/")[1] for r in ref]
        np.testing.assert_allclose([g[1] for g in got], [r[1] for r in ref],
                                   rtol=0, atol=TOL)
    tf.turn_off_clip()
    assert not tf.clip_enabled and tf.clip_dtype is None


def test_embed_texts_pads_with_the_first_row(params, monkeypatch):
    jf = JaxObjectFinder(weights_dir="/nonexistent")
    jf.init_clip(params=params[1])
    jf._tok = tiny_tokenizer()
    tf = ObjectFinder(weights_dir="/nonexistent", device="cpu")
    tf.init_clip(params=params[0])
    tf._tok = tiny_tokenizer()
    seen = []
    real = tclip.encode_text

    def spy(p, ids, **kw):
        seen.append(ids.clone())
        return real(p, ids, **kw)

    monkeypatch.setattr(tobjects.clip_model, "encode_text", spy)
    texts = ["hello", "world", "hello world"]
    got = tf.embed_texts(texts)
    ids = seen[0]
    assert tuple(ids.shape) == (4, 77) and ids.dtype == torch.int64
    assert torch.equal(ids[3], ids[0])
    assert ids[0].tolist() == tf._tok.encode_padded("hello")
    np.testing.assert_allclose(got, jf.embed_texts(texts), rtol=0, atol=TOL)
    np.testing.assert_allclose(tf.embed_text("world"), got[1], rtol=0, atol=1e-5)
    tf._tok = None
    with pytest.raises(RuntimeError, match="vocab"):
        tf.embed_texts(["x"])


def test_object_finder_needs_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        ObjectFinder()
    assert ObjectFinder(device="cpu").device.type == "cpu"


def test_init_clip_fails_without_nvcc_on_cuda(monkeypatch, tmp_path, params):
    """On a CUDA device the attention kernel is built when CLIP is turned
    on: a host without nvcc fails there, before any weights load, instead
    of in every crop ingest (which the NVR catches and prints)."""
    from clearcam_tpu_torch.ops import _build
    monkeypatch.setattr(tobjects, "resolve_device", lambda d: torch.device("cuda", 0))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    finder = ObjectFinder(weights_dir=tmp_path)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        finder.init_clip(params=params[0])
    assert not finder.clip_enabled and finder._clip_params is None


@pytest.mark.slow
def test_full_towers_match_jax():
    """ViT-L/14 at 24 blocks and the text tower at 12, seed 0."""
    mine, ref = tclip.init_params(seed=0), jclip.init_params(seed=0)
    p = tclip.params_from_jax(mine, "cpu")
    px = np.random.default_rng(6).integers(0, 256, (2, 224, 224, 3), np.uint8)
    np.testing.assert_allclose(
        tclip.encode_image(p, torch.from_numpy(px)).numpy(),
        np.asarray(jclip.encode_image(ref, jnp.asarray(px), flash=False)),
        rtol=0, atol=TOL)
    np.testing.assert_allclose(
        tclip.encode_text(p, torch.from_numpy(_tokens())).numpy(),
        np.asarray(jclip.encode_text(ref, jnp.asarray(_tokens()))),
        rtol=0, atol=TOL)
