"""The port on an NVIDIA GPU: the CUDA kernels (stem, ViT attention,
quant-matmul, the decode-attention forms) against their plain versions, and
the models, the detector, the CLIP image tower and the LLM running through
them. Every test needs
the card and skips without one. The file imports no jax, so on a GPU
machine without jax it runs as

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from clearcam_tpu_torch.models import clip, yolov9
from clearcam_tpu_torch.models import llm as tllm
from clearcam_tpu_torch.ops import stem as tstem
from clearcam_tpu_torch.ops import vit_attention as tattn
from clearcam_tpu_torch.runtime.nvr import BatchDetector

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    # full f32 in the plain versions, so f32 comparisons can be tight
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return torch.device("cuda")


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.random(shape, np.float32),
            (rng.standard_normal((3, 3, 3, 16)) * 0.2).astype(np.float32),
            (rng.standard_normal(16) * 0.1).astype(np.float32),
            (rng.standard_normal((3, 3, 16, 32)) * 0.1).astype(np.float32),
            (rng.standard_normal(32) * 0.1).astype(np.float32))


# bf16 bound: the two round conv1 at different points (tests/test_stem.py's
# bound); f32 bound: summation order only
@pytest.mark.parametrize("shape,dtype,tol", [
    ((2, 64, 64, 3), torch.bfloat16, 0.05), ((1, 384, 640, 3), torch.bfloat16, 0.05),
    ((2, 100, 68, 3), torch.float32, 1e-4), ((1, 17, 23, 3), torch.float32, 1e-4),
    ((3, 1, 2, 3), torch.float32, 1e-4), ((8, 384, 640, 3), torch.bfloat16, 0.05),
    ((1, 17, 23, 3), torch.bfloat16, 0.05), ((3, 1, 2, 3), torch.bfloat16, 0.05)])
def test_stem_kernel_matches_plain(cuda, shape, dtype, tol):
    args = [torch.from_numpy(a).to(cuda) for a in _inputs(shape, seed=2)]
    args[0], args[1], args[3] = (args[i].to(dtype) for i in (0, 1, 3))
    before = tstem.stem.launches
    got = tstem.stem(*args)
    ref = tstem.stem_reference(*args)
    torch.cuda.synchronize()
    assert tstem.stem.launches == before + 1
    assert got.shape == ref.shape and got.dtype == dtype
    assert (got.float() - ref.float()).abs().max().item() < tol


def test_stem_kernel_raises_on_bad_input(cuda):
    x, w1, b1, w2, b2 = (torch.from_numpy(a).to(cuda) for a in _inputs((1, 16, 16, 3)))
    with pytest.raises(TypeError):
        tstem.stem(x.half(), w1, b1, w2, b2)
    with pytest.raises(ValueError, match="contiguous"):
        tstem.stem(x.transpose(1, 2), w1, b1, w2, b2)
    with pytest.raises(ValueError, match="w2"):
        tstem.stem(x, w1, b1, w2[..., :16], b2)
    with pytest.raises(ValueError, match="on cpu"):
        tstem.stem(x, w1.cpu(), b1, w2, b2)


def _bf16_args(cuda, shape, seed):
    x, *w = (torch.from_numpy(a).to(cuda) for a in _inputs(shape, seed=seed))
    return x.to(torch.bfloat16), [t.to(torch.bfloat16).float() for t in w]


@pytest.mark.parametrize("shape", [(2, 64, 64, 3), (1, 17, 23, 3), (2, 100, 68, 3)])
def test_stem_packed_equals_hwio_call(cuda, shape):
    """The served route (operands packed once) and the HWIO call launch the
    same kernel: equal outputs; both within bf16 rounding of the GEMM's
    plain version (f32 sums in another order may flip a conv1 rounding)."""
    x, w = _bf16_args(cuda, shape, seed=6)
    packed = tstem.pack(*w)
    before = tstem.stem.launches
    got = tstem.stem_packed(x, packed)
    assert tstem.stem.launches == before + 1
    assert torch.equal(got, tstem.stem(x, *w))
    ref = tstem.gemm_reference(x, packed)
    assert (got.float() - ref.float()).abs().max().item() < 0.05


def test_stem_kernel_input_at_odd_offset(cuda):
    """x 2 bytes past a 4-byte boundary (the second of a batch of 17x23
    frames, 2346 bytes each): the halo's 4-byte loads shift, no narrower
    path."""
    x, w = _bf16_args(cuda, (3, 17, 23, 3), seed=7)
    x = x[1:]
    assert x.data_ptr() % 4 == 2 and x.is_contiguous()
    got = tstem.stem(x, *w)
    ref = tstem.stem_reference(x, *w)
    assert (got.float() - ref.float()).abs().max().item() < 0.05


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_stem_kernel_graph_replay_bitwise_equal(cuda, dtype):
    """Calls and CUDA-graph replays of the stem give the same bits (the
    kernel allocates nothing and its launch sizes come from the shapes)."""
    x, w = _bf16_args(cuda, (2, 96, 160, 3), seed=8)
    x, ops = x.to(dtype), tstem.pack(*w)
    eager = tstem.stem_packed(x, ops)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tstem.stem_packed(x, ops)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = tstem.stem_packed(x, ops)
    for _ in range(3):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)
    assert torch.equal(tstem.stem_packed(x, ops), eager)


def test_stem_packed_raises_on_bad_operands(cuda):
    x, w = _bf16_args(cuda, (1, 16, 16, 3), seed=0)
    packed = tstem.pack(*w)
    with pytest.raises(TypeError):
        tstem.stem_packed(x.half(), packed)
    with pytest.raises(ValueError, match="packed w1k"):
        tstem.stem_packed(x, packed._replace(w1k=packed.w1k.float()))
    with pytest.raises(ValueError, match="packed w1 "):
        tstem.stem_packed(x.float(), packed._replace(w1=packed.w1.bfloat16()))
    with pytest.raises(ValueError, match="aligned"):
        buf = torch.empty(16 * 48 + 1, dtype=torch.bfloat16, device=cuda)
        shifted = buf[1:].view(16, 48).copy_(packed.w1k)
        tstem.stem_packed(x, packed._replace(w1k=shifted))
    with pytest.raises(ValueError, match="on cpu"):
        tstem.stem_packed(x, packed._replace(b1=packed.b1.cpu()))


@pytest.mark.parametrize("size", ["dryrun", "t"])
def test_forward_raw_gpu_matches_cpu(cuda, size):
    """The model through the kernel (GPU) vs through the plain stem (CPU),
    on a rectangular letterbox-shaped input (sides multiples of 32)."""
    params = yolov9.init_params(size, seed=1)
    x = np.random.default_rng(3).uniform(0, 1, (2, 96, 160, 3)).astype(np.float32)
    before = tstem.stem.launches
    with torch.inference_mode():
        got = yolov9.forward_raw(yolov9.params_from_jax(params, cuda),
                                 torch.from_numpy(x).to(cuda), size).cpu().numpy()
        ref = yolov9.forward_raw(yolov9.params_from_jax(params, "cpu"),
                                 torch.from_numpy(x), size).numpy()
    assert tstem.stem.launches == before + 1
    np.testing.assert_allclose(got, ref, rtol=2e-3, atol=2e-3)


def test_batch_detector_bf16_on_gpu(cuda):
    det = BatchDetector("t", res=320, device="cuda")
    assert det.kernel_library and det.params["stem.w1"].dtype == torch.float32
    frames = list(np.random.default_rng(4).integers(0, 256, (3, 360, 640, 3), np.uint8))
    before = tstem.stem.launches
    rows = det.detect_many(frames)
    assert tstem.stem.launches == before + 1          # one bucket of 4
    assert all(r.shape == (300, 6) and np.isfinite(r).all() for r in rows)


# f32 bound: summation order and exp2 vs exp only (TF32 off); bf16 bound:
# the plain version rounds the probabilities to bf16 before the PV product
ATTN_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _qkv(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape, np.float32)).cuda().to(dtype)
            for _ in range(3)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(16, 16, 257, 64), (1, 16, 257, 64)]
                         + [(2, 16, t, 64) for t in (1, 7, 128, 129, 784, 1600)]
                         + [(1, 16, 2040, 64)])
def test_vit_attention_kernel_matches_plain(cuda, shape, dtype):
    q, k, v = _qkv(shape, dtype, seed=shape[2])
    before = tattn.mha_flash.launches
    got = tattn.mha_flash(q, k, v)
    ref = tattn.mha_reference(q, k, v)
    torch.cuda.synchronize()
    assert tattn.mha_flash.launches == before + 1
    assert got.shape == ref.shape and got.dtype == dtype
    assert (got.float() - ref.float()).abs().max().item() < ATTN_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vit_attention_kernel_reads_strided_heads(cuda, dtype):
    """The heads of a fused qkv projection, read in place, with a scale."""
    qkv = _qkv((2, 257, 3 * 1024), dtype, seed=5)[0]
    q, k, v = (t.view(2, 257, 16, 64).transpose(1, 2) for t in qkv.chunk(3, -1))
    got = tattn.mha_flash(q, k, v, sm_scale=0.1)
    ref = tattn.mha_reference(q, k, v, sm_scale=0.1)
    assert got.dtype == dtype
    assert (got.float() - ref.float()).abs().max().item() < ATTN_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vit_attention_is_bitwise_deterministic_and_replays_in_a_cuda_graph(cuda, dtype):
    """Two eager calls give the same bits; so do CUDA-graph replays of two
    interleaved shapes (CLIP's and a summary frame's, two plans) with new
    q, k, v written in place between replays."""
    rng = np.random.default_rng(9)
    shapes = [(4, 16, 257, 64), (1, 16, 2040, 64)]
    assert len({tattn.plan(b, h, t, dtype) for b, h, t, _ in shapes}) == 2
    ins = [_qkv(shape, dtype, seed=i) for i, shape in enumerate(shapes)]
    first = [tattn.mha_flash(*x) for x in ins]
    again = [tattn.mha_flash(*x) for x in ins]
    for a, b in zip(first, again):
        assert torch.equal(a, b)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):                   # warm-up outside the capture
        for x in ins:
            tattn.mha_flash(*x)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [tattn.mha_flash(*x) for x in ins] + [tattn.mha_flash(*ins[0])]
    for fresh in (True, True, False):              # the last: the first inputs again
        for i, x in enumerate(ins):
            new = _qkv(shapes[i], dtype, seed=int(rng.integers(1 << 30)) if fresh else i)
            for t, n in zip(x, new):
                t.copy_(n)
        graph.replay()
        torch.cuda.synchronize()
        eager = [tattn.mha_flash(*x) for x in ins]
        assert torch.equal(outs[0], eager[0]) and torch.equal(outs[2], eager[0])
        assert torch.equal(outs[1], eager[1])
        for x, o in zip(ins, outs):
            ref = tattn.mha_reference(*x)
            assert (o.float() - ref.float()).abs().max().item() < ATTN_TOL[dtype]
    assert all(torch.equal(a, b) for a, b in zip(first, outs))


def test_vit_attention_refuses_what_cp_async_cannot_copy(cuda):
    """The kernel copies 16-byte chunks: bf16 strides must be multiples of
    8 elements and the base 16-byte aligned (4 elements and 8 bytes passed
    before the tensor-core design); the fused-qkv heads always are."""
    buf = _qkv((1, 2, 9, 3 * 64 + 4), torch.bfloat16, seed=2)[0]
    q = buf[..., :64]                            # t stride 196: a multiple of 4, not 8
    with pytest.raises(ValueError, match="16 bytes"):
        tattn.mha_flash(q, q, q)
    flat = torch.zeros(2 * 9 * 64 + 8, dtype=torch.bfloat16, device=cuda)
    shifted = flat[4:-4].view(1, 2, 9, 64)       # base 8 bytes past a 16-byte boundary
    with pytest.raises(ValueError, match="16 bytes"):
        tattn.mha_flash(shifted, shifted, shifted)
    fine = flat[8:].view(1, 2, 9, 64)            # 16 bytes past: taken
    assert tattn.mha_flash(fine, fine, fine).shape == (1, 2, 9, 64)


def test_vit_attention_kernel_raises_on_bad_input(cuda):
    q, k, v = _qkv((1, 2, 9, 64), torch.float32, seed=1)
    with pytest.raises(TypeError):
        tattn.mha_flash(q.half(), k.half(), v.half())
    with pytest.raises(TypeError):
        tattn.mha_flash(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="head dim"):
        tattn.mha_flash(*(t[..., :32] for t in (q, k, v)))
    with pytest.raises(ValueError, match="on cpu"):
        tattn.mha_flash(q, k.cpu(), v)
    with pytest.raises(ValueError, match="strides"):
        tattn.mha_flash(q, k.transpose(-1, -2).contiguous().transpose(-1, -2), v)


def test_clip_image_tower_gpu_matches_cpu(cuda):
    """Two full-width blocks: the tower through the kernel (GPU) against the
    plain tower on the CPU."""
    params = clip.init_params(seed=0, img_blocks=2, txt_blocks=1)
    px = np.random.default_rng(6).integers(0, 256, (3, 224, 224, 3), np.uint8)
    before = tattn.mha_flash.launches
    with torch.inference_mode():
        got = clip.encode_image(clip.params_from_jax(params, cuda),
                                torch.from_numpy(px).to(cuda)).cpu().numpy()
        ref = clip.encode_image(clip.params_from_jax(params, "cpu"),
                                torch.from_numpy(px)).numpy()
    assert tattn.mha_flash.launches == before + 2
    cos = (got * ref).sum(-1) / np.linalg.norm(got, axis=-1) / np.linalg.norm(ref, axis=-1)
    assert cos.min() > 1 - 1e-5, cos
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_object_finder_on_gpu(cuda, tmp_path):
    """CLIP on through the port's ObjectFinder: init_clip sets the kernel
    up, a batch of crops goes through it (one launch per block), and the
    embeddings match the CPU finder's."""
    from clearcam_tpu_torch.models.objects import ObjectFinder
    params = clip.init_params(seed=2, img_blocks=1, txt_blocks=1)
    gpu = ObjectFinder(weights_dir=tmp_path, device="cuda")
    gpu.init_clip(params=params)
    assert gpu.kernel_library and gpu.clip_dtype == torch.float32
    cpu = ObjectFinder(weights_dir=tmp_path, device="cpu")
    cpu.init_clip(params=params)
    crops = list(np.random.default_rng(7).integers(0, 256, (3, 150, 100, 3), np.uint8))
    before = tattn.mha_flash.launches
    got = gpu.embed_images(crops)
    assert tattn.mha_flash.launches == before + 1
    np.testing.assert_allclose(got, cpu.embed_images(crops), rtol=0, atol=1e-4)


# quant-matmul kernel vs plain, relative to the output's magnitude: f32 x
# differs by summation order only; bf16 x rounds both outputs to bf16
QM_TOL = {torch.float32: 1e-5, torch.bfloat16: 8e-3}


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [1, 2, 3, 5, 16, 17, 32, 130, 256, 520])
@pytest.mark.parametrize("oi", [(300, 700), (1024, 2048), (6144, 2048), (2048, 6144)])
def test_quant_matmul_kernel_matches_plain(cuda, bits, dtype, rows, oi):
    from clearcam_tpu_torch.ops import quant_matmul as tqm
    rng = np.random.default_rng(rows)
    w = torch.from_numpy(rng.normal(0, 0.05, oi).astype(np.float32)).to(cuda)
    ql = tqm.quantize_int8(w) if bits == 8 else tqm.quantize_int4(w)
    x = torch.from_numpy(rng.standard_normal((rows, oi[1]), np.float32)).to(cuda, dtype)
    b = torch.from_numpy(rng.normal(0, 0.1, oi[0]).astype(np.float32)).to(cuda)
    before = tqm.quant_linear.launches
    got = tqm.quant_linear(x, ql, b)
    ref = tqm.quant_linear_reference(x, ql, b)
    torch.cuda.synchronize()
    assert tqm.quant_linear.launches == before + 1
    assert got.shape == ref.shape == (rows, oi[0]) and got.dtype == dtype
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= QM_TOL[dtype] * ref.float().abs().max().item()


@pytest.mark.parametrize("bits", [8, 4])
def test_quant_matmul_is_bitwise_deterministic_and_replays_in_a_cuda_graph(cuda, bits):
    """Two eager calls give the same bits; so do graph replays of two
    interleaved shapes (split and unsplit plans) with new x written in
    place: the split counters come back to 0 after every call."""
    from clearcam_tpu_torch.ops import quant_matmul as tqm
    rng = np.random.default_rng(bits)
    quant = tqm.quantize_int8 if bits == 8 else tqm.quantize_int4
    ws = [quant(torch.from_numpy(rng.normal(0, 0.05, oi).astype(np.float32)).to(cuda))
          for oi in ((2048, 6144), (151936 // 16, 2048))]
    xs = [torch.zeros((rows, w.in_features), device=cuda) for rows, w in zip((8, 256), ws)]
    pads = [(w.s.shape[1], (w.q.shape[1] if bits == 8 else 2 * w.packed.shape[1]))
            for w in ws]
    assert [tqm.plan(x.shape[0], *pad, bits == 4).splits > 1
            for x, pad in zip(xs, pads)] == [True, False]

    def fill(seed):
        g = np.random.default_rng(seed)
        for x in xs:
            x.copy_(torch.from_numpy(g.standard_normal(tuple(x.shape), np.float32)))

    fill(0)
    first = [tqm.quant_linear(x, w) for x, w in zip(xs, ws)]
    again = [tqm.quant_linear(x, w) for x, w in zip(xs, ws)]
    for a, b in zip(first, again):
        assert torch.equal(a, b)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):                   # warm-up outside the capture
        for x, w in zip(xs, ws):
            tqm.quant_linear(x, w)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [tqm.quant_linear(x, w) for x, w in zip(xs, ws)] + \
            [tqm.quant_linear(xs[0], ws[0])]
    for seed in (1, 2, 0):
        fill(seed)
        graph.replay()
        torch.cuda.synchronize()
        eager = [tqm.quant_linear(x, w) for x, w in zip(xs, ws)]
        assert torch.equal(outs[0], eager[0]) and torch.equal(outs[2], eager[0])
        assert torch.equal(outs[1], eager[1])
        for x, w, o in zip(xs, ws, outs):
            ref = tqm.quant_linear_reference(x, w)
            assert (o - ref).abs().max().item() <= QM_TOL[torch.float32] * ref.abs().max().item()
    assert [torch.equal(a, b) for a, b in zip(first, outs)] == [True, True]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quant_matmul_widens_every_int8_value_exactly(cuda, dtype):
    """All 256 int8 values through the kernel: x one-hot rows pick single
    weights, with scale 1, so the output is the widened weight itself."""
    from clearcam_tpu_torch.ops import quant_matmul as tqm
    o = torch.arange(256).reshape(-1, 1)
    q = (((o + torch.arange(1024)) % 256) - 128).to(torch.int8)    # every value per column
    ql = tqm.QuantLinear(q.to(cuda), torch.ones((1, 256), device=cuda), 256, 1024)
    x = torch.eye(256, 1024, device=cuda, dtype=dtype)              # row n picks input n
    got = tqm.quant_linear(x, ql)
    torch.cuda.synchronize()
    assert torch.equal(got.float().cpu(), q[:, :256].T.float())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quant_matmul_widens_every_int4_byte_exactly(cuda, dtype):
    """All 256 packed bytes, both nibbles, through the kernel against
    ``QuantLinear4.unpack``: one-hot rows of x at input j (low nibble of
    byte j) and j + 512 (high nibble), scales 1."""
    from clearcam_tpu_torch.ops import quant_matmul as tqm
    o = torch.arange(256).reshape(-1, 1)
    packed = (((o + torch.arange(512)) % 256) - 128).to(torch.int8)
    ql = tqm.QuantLinear4(packed.to(cuda), torch.ones((8, 256), device=cuda), 256, 1024)
    cols = torch.cat([torch.arange(128), 512 + torch.arange(128)])
    x = torch.zeros((256, 1024), device=cuda, dtype=dtype)
    x[torch.arange(256), cols.to(cuda)] = 1
    got = tqm.quant_linear(x, ql)
    torch.cuda.synchronize()
    want = ql.to("cpu").unpack()[:, cols].T.float()
    assert set(packed[:, :128].flatten().tolist()) == set(range(-128, 128))
    assert torch.equal(got.float().cpu(), want)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_on_the_card_gives_the_cpu_bytes(cuda, bits):
    from clearcam_tpu_torch.ops import quant_matmul as tqm
    fn = tqm.quantize_int8 if bits == 8 else tqm.quantize_int4
    w = torch.from_numpy(np.random.default_rng(bits).normal(0, 0.05, (2048, 2100))
                         .astype(np.float32))
    cpu, gpu = fn(w), fn(w.to(cuda))
    for name in ("q", "s") if bits == 8 else ("packed", "s"):
        assert torch.equal(getattr(cpu, name), getattr(gpu, name).cpu()), name


def test_quant_matmul_leading_dims_and_raises(cuda):
    from clearcam_tpu_torch.ops import quant_matmul as tqm
    w = torch.randn(256, 1024, device=cuda) * 0.05
    ql = tqm.quantize_int8(w)
    x = torch.randn(2, 3, 1024, device=cuda)
    got = tqm.quant_linear(x, ql)
    assert got.shape == (2, 3, 256)
    ref = tqm.quant_linear_reference(x, ql)
    assert (got - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()
    with pytest.raises(TypeError):
        tqm.quant_linear(x.half(), ql)
    with pytest.raises(ValueError, match="features"):
        tqm.quant_linear(x[..., :512], ql)
    with pytest.raises(ValueError, match="on cpu"):
        tqm.quant_linear(x, ql.to("cpu"))


# decode-attention kernel vs plain (f32 softmax over the whole cache):
# summation order only in f32; a bf16 q rounds both outputs to bf16
DEC_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("qdt,cdt", [(torch.float32, torch.float32),
                                     (torch.float32, torch.bfloat16),
                                     (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("h,kvh", [(8, 4), (16, 8), (16, 2), (8, 8)])
def test_decode_attention_kernel_matches_plain(cuda, qdt, cdt, h, kvh):
    from clearcam_tpu_torch.ops import decode_attention as tdec
    rng = np.random.default_rng(h * kvh)
    b, s, d = 4, 517, 128
    q = torch.from_numpy(rng.standard_normal((b, h, d), np.float32)).to(cuda, qdt)
    k, v = (torch.from_numpy(rng.standard_normal((b, kvh, s, d), np.float32)).to(cuda, cdt)
            for _ in range(2))
    for pos, pads in ((torch.tensor([0, 63, 300, 516], dtype=torch.int32), None),
                      (torch.tensor([64, 300, 300, 516], dtype=torch.int32),
                       torch.tensor([64, 0, 299, 37], dtype=torch.int32)),
                      (200, None)):
        pos = pos.to(cuda) if isinstance(pos, torch.Tensor) else pos
        pads = pads.to(cuda) if pads is not None else None
        before = tdec.decode_attention_batch.launches
        got = tdec.decode_attention_batch(q, k, v, pos, pads)
        ref = tdec.decode_attention_batch_reference(q, k, v, pos, pads)
        torch.cuda.synchronize()
        assert tdec.decode_attention_batch.launches == before + 1
        assert got.shape == q.shape and got.dtype == qdt
        assert (got.float() - ref.float()).abs().max().item() < DEC_TOL[qdt]


def test_decode_attention_kernel_raises_on_bad_input(cuda):
    from clearcam_tpu_torch.ops import decode_attention as tdec
    q = torch.randn(2, 8, 128, device=cuda)
    k = torch.randn(2, 4, 64, 128, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        tdec.decode_attention_batch(q[..., :64].contiguous(), k[..., :64].contiguous(),
                                    k[..., :64].contiguous(), 3)
    with pytest.raises(TypeError):
        tdec.decode_attention_batch(q, k, k.bfloat16(), 3)
    with pytest.raises(ValueError, match="contiguous"):
        tdec.decode_attention_batch(q, k.transpose(2, 3).contiguous().transpose(2, 3), k, 3)
    with pytest.raises(ValueError, match="H / KvH"):
        tdec.decode_attention_batch(torch.randn(2, 40, 128, device=cuda), k[:, :4], k[:, :4], 3)


def _small_llm_cfg():
    return tllm.TransformerConfig(
        num_blocks=2, dim=256, hidden_dim=512, n_heads=4, n_kv_heads=2,
        norm_eps=1e-6, vocab_size=512, head_dim=128, rope_theta=1e6,
        rope_dim=128, v_head_dim=128, max_context=256, qk_norm=128)


@pytest.mark.parametrize("quant", ["none", "int8", "int4"])
def test_engine_gpu_matches_cpu(cuda, quant):
    """Two blocks, greedy: the engine on the card (quant-matmul and decode
    kernels) gives the CPU engine's tokens (plain versions)."""
    from clearcam_tpu_torch.ops import decode_attention as tdec
    from clearcam_tpu_torch.ops import quant_matmul as tqm
    from clearcam_tpu_torch.serving import ServingEngine
    cfg = _small_llm_cfg()
    prompts = [[1, 2, 3, 4, 5], list(range(10, 50)), [7, 7, 7]]
    outs = {}
    before = (tqm.quant_linear.launches, tdec.decode_attention_batch.launches)
    for dev in ("cpu", "cuda"):
        p = tllm.init_params(cfg, seed=5, device=dev)
        if quant != "none":
            p = getattr(tllm, f"quantize_params_{quant}")(p)
        eng = ServingEngine(p, cfg, n_slots=2, use_pallas_decode=True)
        reqs = [eng.submit(pr, max_new=6) for pr in prompts]
        eng.run_until_idle()
        outs[dev] = [r.wait(1) for r in reqs]
    assert outs["cpu"] == outs["cuda"]
    assert tdec.decode_attention_batch.launches > before[1]
    assert (tqm.quant_linear.launches > before[0]) == (quant != "none")


@pytest.mark.parametrize("m,k,n", [(16, 128, 8192), (16, 8192, 128), (64, 128, 300)])
def test_attention_products_keep_f32_scores_on_the_card(cuda, m, k, n):
    """bf16 operands (the bf16 KV cache) multiply with an f32 output on the
    card, as the CPU's widened product does: no bf16 rounding of the scores.
    The key cache comes in as a transposed view, as the attention block
    passes it."""
    g = torch.Generator().manual_seed(3)
    a = torch.randn(2, 8, m, k, generator=g).bfloat16()
    b = torch.randn(2, 8, n, k, generator=g).bfloat16().transpose(-1, -2)
    ref = tllm._product_f32(a, b)
    got = tllm._product_f32(a.to(cuda), b.to(cuda))
    got = got.cpu()
    assert got.dtype == torch.float32 and got.shape == ref.shape
    # f32 sums in another order (up to 8192 terms): far below the 2^-9
    # relative error of rounding the scores to bf16 ...
    err = (got - ref).abs().max().item()
    assert err <= 1e-4 * ref.abs().max().item(), err
    # ... and the outputs are not bf16 values
    assert (got != got.bfloat16().float()).float().mean().item() > 0.9


# bf16 weights and KV cache at dim 256 (logits ~1): bf16 outputs one ulp
# apart where cuBLAS and the CPU sum in other orders
LLM_BF16_TOL = 3e-2


@pytest.mark.parametrize("pallas", [True, False])
def test_bf16_model_gpu_matches_cpu(cuda, pallas):
    """bf16 weights and a bf16 KV cache (serve_llm's default without
    --int8): a prefill chunk then a decode step at per-row positions, card
    vs CPU logits, through the decode kernel or the plain attention."""
    from clearcam_tpu_torch.ops import decode_attention as tdec
    cfg = _small_llm_cfg()
    toks = np.random.default_rng(4).integers(1, cfg.vocab_size, (2, 32))
    out = {}
    for dev in ("cpu", "cuda"):
        p = {k: v.bfloat16() for k, v in tllm.init_params(cfg, seed=5, device=dev).items()}
        st = tllm.init_state(cfg, 2, dtype=torch.bfloat16, device=dev)
        fr = tllm.freqs_for(cfg, dev)
        impl = None if dev == "cpu" or not pallas else (
            lambda q, s_, pos, pads: tdec.decode_attention_batch(
                q[:, :, 0].contiguous(), s_["k"], s_["v"], pos, pads)[:, :, None])
        with torch.inference_mode():
            h, _ = tllm.forward(p, cfg, st, torch.from_numpy(toks).to(dev), 0, fr)
            first = tllm.logits_at(p, cfg, h, 31)
            h, _ = tllm.forward(p, cfg, st, torch.from_numpy(toks[:, :1]).to(dev),
                                torch.tensor([32, 20], device=dev), fr, decode_attn=impl)
            out[dev] = [first.float().cpu(), tllm.logits_at(p, cfg, h, 0).float().cpu()]
    for ref, got in zip(out["cpu"], out["cuda"]):
        assert torch.isfinite(got).all()
        assert (got - ref).abs().max().item() < LLM_BF16_TOL


def _q8_cache(rng, b, kvh, s, cuda):
    kq, vq = (torch.from_numpy(rng.integers(-127, 128, (b, kvh, s, 128)).astype(np.int8))
              .to(cuda) for _ in range(2))
    ks, vs = (torch.from_numpy(rng.uniform(0.002, 0.02, (b, kvh, s)).astype(np.float32))
              .to(cuda) for _ in range(2))
    return kq, ks, vq, vs


@pytest.mark.parametrize("qdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,kvh", [(8, 4), (16, 8), (16, 2), (8, 8)])
def test_decode_attention_q8_kernel_matches_plain(cuda, qdt, h, kvh):
    """The int8-cache kernel against its plain version on the same int8
    bytes and scales: f32 q bounded as the f32 caches (summation order
    only); a row with no live column gives zeros on both."""
    from clearcam_tpu_torch.ops import decode_attention as tdec
    rng = np.random.default_rng(h * kvh + 1)
    b, s = 4, 517
    q = torch.from_numpy(rng.standard_normal((b, h, 128), np.float32)).to(cuda, qdt)
    kq, ks, vq, vs = _q8_cache(rng, b, kvh, s, cuda)
    for pos, pads in ((torch.tensor([0, 63, 300, 516], dtype=torch.int32), None),
                      (torch.tensor([64, 300, 10, 516], dtype=torch.int32),
                       torch.tensor([64, 0, 299, 37], dtype=torch.int32)),
                      (200, None)):
        pos = pos.to(cuda) if isinstance(pos, torch.Tensor) else pos
        pads = pads.to(cuda) if pads is not None else None
        before = (tdec.decode_attention_batch_q8.launches, tdec.decode_attention_batch.launches)
        got = tdec.decode_attention_batch_q8(q, kq, ks, vq, vs, pos, pads)
        ref = tdec.decode_attention_batch_q8_reference(q, kq, ks, vq, vs, pos, pads)
        torch.cuda.synchronize()
        assert (tdec.decode_attention_batch_q8.launches,
                tdec.decode_attention_batch.launches) == (before[0] + 1, before[1])
        assert got.shape == q.shape and got.dtype == qdt
        assert torch.isfinite(got).all()
        assert (got.float() - ref.float()).abs().max().item() < DEC_TOL[qdt]


@pytest.mark.parametrize("q8,cdt", [(False, torch.float32), (False, torch.bfloat16),
                                    (True, torch.int8)])
def test_single_stream_kernels_match_plain(cuda, q8, cdt):
    """decode_attention and decode_attention_q8 (the batch kernels at
    B = 1, scalar pos) against their plain versions; each counts its own
    launches only."""
    from clearcam_tpu_torch.ops import decode_attention as tdec
    rng = np.random.default_rng(3)
    h, kvh, s = 16, 8, 2048
    q = torch.from_numpy(rng.standard_normal((h, 128), np.float32)).to(cuda)
    if q8:
        kq, ks, vq, vs = (t[0] for t in _q8_cache(rng, 1, kvh, s, cuda))
        fn, ref_fn, args = tdec.decode_attention_q8, tdec.decode_attention_q8_reference, \
            (kq, ks, vq, vs)
    else:
        k, v = (torch.from_numpy(rng.standard_normal((kvh, s, 128), np.float32))
                .to(cuda, cdt) for _ in range(2))
        fn, ref_fn, args = tdec.decode_attention, tdec.decode_attention_reference, (k, v)
    for pos in (0, 63, 256, 1000, 2047):
        counts = [f.launches for f in (tdec.decode_attention, tdec.decode_attention_q8,
                                       tdec.decode_attention_batch,
                                       tdec.decode_attention_batch_q8)]
        got = fn(q, *args, pos)
        ref = ref_fn(q, *args, pos)
        torch.cuda.synchronize()
        after = [f.launches for f in (tdec.decode_attention, tdec.decode_attention_q8,
                                      tdec.decode_attention_batch,
                                      tdec.decode_attention_batch_q8)]
        assert after == [c + (i == int(q8)) for i, c in enumerate(counts)]
        assert got.shape == (h, 128)
        assert (got - ref).abs().max().item() < DEC_TOL[torch.float32]


def test_decode_attention_q8_kernel_raises_on_bad_input(cuda):
    from clearcam_tpu_torch.ops import decode_attention as tdec
    rng = np.random.default_rng(0)
    q = torch.randn(2, 8, 128, device=cuda)
    kq, ks, vq, vs = _q8_cache(rng, 2, 4, 64, cuda)
    with pytest.raises(TypeError):
        tdec.decode_attention_batch_q8(q, kq.float(), ks, vq.float(), vs, 3)
    with pytest.raises(ValueError, match="k_s"):
        tdec.decode_attention_batch_q8(q, kq, ks.double(), vq, vs, 3)
    with pytest.raises(ValueError, match="contiguous"):
        tdec.decode_attention_batch_q8(q, kq, ks[:, :, ::2], vq, vs, 3)
    with pytest.raises(ValueError, match="scalar"):
        tdec.decode_attention_q8(q[0], kq[0], ks[0], vq[0], vs[0],
                                 torch.tensor([1, 2], device=cuda))


def _split_windows(chunk, s):
    """(pos, pads) for 8 rows against the split plan's chunk: one position,
    exactly one chunk, a window ending on a chunk's last position, one
    starting inside a chunk and ending on a chunk's first, the whole cache,
    a row with pads > pos (no live column), position 0, one past a chunk."""
    rows = [(5000, 5000), (4 * chunk - 1, 3 * chunk), (5 * chunk - 1, 0),
            (5 * chunk, chunk + 17), (s - 1, 0), (99, 100), (0, 0), (chunk, chunk - 1)]
    return ([torch.tensor([r[i] for r in rows], dtype=torch.int32) for i in (0, 1)])


@pytest.mark.parametrize("cache", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("h,kvh", [(8, 8), (16, 8), (16, 2)])
def test_decode_attention_split_windows_match_plain(cuda, cache, h, kvh):
    """B = 8, S = 8192: windows placed against the plan's chunks, rep 1, 2
    and 8, f32 and bf16 q, every cache type; the row with no live column is
    zeros in both."""
    from clearcam_tpu_torch.ops import decode_attention as tdec
    rng = np.random.default_rng(h + kvh)
    b, s = 8, 8192
    chunk, splits = tdec.plan(b, kvh, s)
    assert splits > 8
    pos, pads = (t.to(cuda) for t in _split_windows(chunk, s))
    q = torch.from_numpy(rng.standard_normal((b, h, 128), np.float32)).to(cuda)
    if cache == "int8":
        kq, ks, vq, vs = _q8_cache(rng, b, kvh, s, cuda)
        fn, ref_fn = tdec.decode_attention_batch_q8, tdec.decode_attention_batch_q8_reference
        args = (kq, ks, vq, vs)
    else:
        k, v = (torch.from_numpy(rng.standard_normal((b, kvh, s, 128), np.float32))
                .to(cuda, getattr(torch, cache)) for _ in range(2))
        fn, ref_fn, args = tdec.decode_attention_batch, tdec.decode_attention_batch_reference, \
            (k, v)
    for qq in (q, q.bfloat16()) if cache != "float32" else (q,):
        before = fn.launches
        got = fn(qq, *args, pos, pads)
        ref = ref_fn(qq, *args, pos, pads)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        assert got.dtype == qq.dtype and torch.isfinite(got).all()
        assert not got[5].any() and not ref[5].any()
        assert (got.float() - ref.float()).abs().max().item() < DEC_TOL[qq.dtype]


@pytest.mark.parametrize("form", ["batch", "batch_q8", "single", "single_q8"])
def test_decode_attention_replays_in_a_cuda_graph(cuda, form):
    """Each form captured once in a CUDA graph and replayed with new
    positions (and pads) written in place: the plan reads nothing from pos,
    so each replay matches the plain version at the new window."""
    from clearcam_tpu_torch.ops import decode_attention as tdec
    rng = np.random.default_rng(7)
    b, h, kvh, s = (8 if form.startswith("batch") else 1), 16, 8, 8192
    q = torch.from_numpy(rng.standard_normal((b, h, 128), np.float32)).to(cuda)
    if form.endswith("q8"):
        cache = _q8_cache(rng, b, kvh, s, cuda)
    else:
        cache = tuple(torch.from_numpy(rng.standard_normal((b, kvh, s, 128), np.float32))
                      .to(cuda, torch.bfloat16) for _ in range(2))
    batch = form.startswith("batch")
    pos = torch.zeros(b if batch else (), dtype=torch.int32, device=cuda)
    pads = torch.zeros(b, dtype=torch.int32, device=cuda)
    fn = {"batch": tdec.decode_attention_batch, "batch_q8": tdec.decode_attention_batch_q8,
          "single": tdec.decode_attention, "single_q8": tdec.decode_attention_q8}[form]
    ref_fn = {"batch": tdec.decode_attention_batch_reference,
              "batch_q8": tdec.decode_attention_batch_q8_reference,
              "single": tdec.decode_attention_reference,
              "single_q8": tdec.decode_attention_q8_reference}[form]

    def call(f):
        if batch:
            return f(q, *cache, pos, pads)
        return f(q[0], *(t[0] for t in cache), pos)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):                   # warm-up outside the capture
        call(fn)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call(fn)
    windows = [([0] * b, [0] * b), ([8191] * b, [0] * b),
               ([100, 8000, 4096, 255, 5, 7000, 1, 2047][:b], [0, 6000, 100, 255, 9, 0, 0, 64][:b])]
    for p_new, pad_new in windows:
        if batch:
            pos.copy_(torch.tensor(p_new, dtype=torch.int32))
            pads.copy_(torch.tensor(pad_new, dtype=torch.int32))
        else:
            pos.fill_(p_new[0])
        graph.replay()
        torch.cuda.synchronize()
        ref = call(ref_fn)
        assert (out - ref).abs().max().item() < DEC_TOL[torch.float32], (form, p_new)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_transformer_decode_kernels_gpu_match_cpu(cuda, kv):
    """Transformer.generate with use_pallas_decode, greedy: the card (the
    single-stream kernels) gives the CPU's tokens (plain versions), and
    generate_batch on the card (the batch kernels) gives each row's."""
    from clearcam_tpu_torch.ops import decode_attention as tdec
    cfg = _small_llm_cfg()
    q8 = kv == "int8"
    dt = torch.bfloat16 if kv == "bf16" else torch.float32
    prompt = list(np.random.default_rng(2).integers(1, cfg.vocab_size, 40))
    out = {}
    for dev in ("cpu", "cuda"):
        p = tllm.init_params(cfg, seed=5, device=dev)
        m = tllm.Transformer(p, cfg, state_dtype=dt, kv_quant=q8, use_pallas_decode=True)
        single = list(m.generate(prompt, temperature=0.0, max_new=8))
        batch = tllm.generate_batch(p, cfg, [prompt, prompt[:9]], max_new=8, state_dtype=dt,
                                    kv_quant=q8, use_pallas_decode=True)
        out[dev] = (single, batch)
    assert out["cpu"] == out["cuda"]
    assert (tdec.decode_attention_q8 if q8 else tdec.decode_attention).launches > 0
    assert (tdec.decode_attention_batch_q8 if q8 else tdec.decode_attention_batch).launches > 0


def test_engine_kv_quant_decode_kernel_gpu_matches_cpu(cuda):
    """The engine's int8-cache kernel route: decode_attention_batch_q8 with
    the cache's scales on the card gives the CPU engine's tokens (its
    plain version), and the card's plain int8 route's."""
    from clearcam_tpu_torch.ops import decode_attention as tdec
    from clearcam_tpu_torch.serving import ServingEngine
    cfg = _small_llm_cfg()
    prompts = [[1, 2, 3, 4, 5], list(range(10, 50)), [7, 7, 7]]
    outs = {}
    before = tdec.decode_attention_batch_q8.launches
    for dev, pallas in (("cpu", True), ("cuda", True), ("cuda", False)):
        p = tllm.quantize_params_int8(tllm.init_params(cfg, seed=5, device=dev))
        eng = ServingEngine(p, cfg, n_slots=2, kv_quant=True, use_pallas_decode=pallas)
        reqs = [eng.submit(pr, max_new=6) for pr in prompts]
        eng.run_until_idle()
        outs[dev, pallas] = [r.wait(1) for r in reqs]
    assert outs["cpu", True] == outs["cuda", True] == outs["cuda", False]
    assert tdec.decode_attention_batch_q8.launches > before


@pytest.mark.parametrize("family", ["moe", "hybrid"])
def test_moe_and_hybrid_engines_gpu_match_cpu(cuda, family):
    """A tiny MoE stack (through the decode kernel) and a tiny
    GatedDeltaNet hybrid, int8 weights, on the card: the CPU engine's
    greedy tokens, with the quant kernel launched (the expert stacks are
    plain torch, the other products the kernel)."""
    from clearcam_tpu_torch.ops import decode_attention as tdec
    from clearcam_tpu_torch.ops import quant_matmul as tqm
    from clearcam_tpu_torch.serving import ServingEngine
    extra = (dict(num_experts=8, num_experts_per_tok=2, norm_topk_prob=True,
                  hidden_dim=256, shared_expert_dim=256) if family == "moe" else
             dict(full_attention_interval=2, ssm=tllm.SSMConfig(
                 conv_kernel=4, state_size=64, group_count=2, time_step_rank=4,
                 inner_size=256)))
    cfg = dataclasses.replace(_small_llm_cfg(), **extra)
    prompts = [[1, 2, 3, 4, 5], list(range(10, 50)), [7, 7, 7]]
    outs = {}
    before = (tqm.quant_linear.launches, tdec.decode_attention_batch.launches)
    for dev in ("cpu", "cuda"):
        p = tllm.quantize_params_int8(tllm.init_params(cfg, seed=5, device=dev))
        eng = ServingEngine(p, cfg, n_slots=2, use_pallas_decode=family == "moe")
        reqs = [eng.submit(pr, max_new=6) for pr in prompts]
        eng.run_until_idle()
        outs[dev] = [r.wait(1) for r in reqs]
    assert outs["cpu"] == outs["cuda"]
    assert tqm.quant_linear.launches > before[0]
    assert (tdec.decode_attention_batch.launches > before[1]) == (family == "moe")


def test_spec_engine_gpu_matches_cpu(cuda):
    """Speculative windows on the card: the CPU's tokens, the non-spec
    engine's, and more tokens than decode dispatches on a periodic prompt."""
    from clearcam_tpu_torch.serving import ServingEngine
    cfg = _small_llm_cfg()
    prompts = [[5, 6, 7] * 8, list(range(10, 50)), [7, 7, 7]]
    outs = {}
    for dev, spec in (("cpu", 4), ("cuda", 4), ("cuda", 0)):
        p = tllm.init_params(cfg, seed=5, device=dev)
        eng = ServingEngine(p, cfg, n_slots=2, spec_lookup=spec, sync_lag=0, fetch_every=1)
        reqs = [eng.submit(pr, max_new=24) for pr in prompts]
        eng.run_until_idle()
        outs[dev, spec] = [r.wait(1) for r in reqs]
        if spec:
            assert eng.stats["spec_emitted"] > eng.stats["decode_steps"]
    assert outs["cpu", 4] == outs["cuda", 4] == outs["cuda", 0]


@pytest.mark.parametrize("dtype,iters", [(torch.float32, 256), (torch.float32, None),
                                         (torch.bfloat16, 256), (torch.bfloat16, None)])
@pytest.mark.parametrize("kind", ["ones", "random"])
def test_vpu_probe_kernel_matches_plain(cuda, dtype, iters, kind):
    """The probe kernel against probe_reference on the same tile: f32
    (FFMA, one rounding on both sides) within 1e-5 of max|plain|. bf16:
    __hfma2 rounds once where the plain version rounds twice, and each
    chain stops anywhere in a band of about ulp / (1 - c_j) around its
    fixed point, so the two settle apart: on the tool's input (ones)
    within 1.0, two bf16 ulps of the ~95 sum; on random inputs within 8
    ulps of max|plain| (a CPU model of the fused form reaches 5 over
    65,536 inputs in [0.25, 2])."""
    from clearcam_tpu_torch.tools import vpu_probe as tvp
    x = torch.ones((tvp.ROWS, 128), device=cuda) if kind == "ones" else \
        torch.rand((tvp.ROWS, 128), device=cuda, generator=torch.Generator(
            device="cuda").manual_seed(1)) + 0.5
    x = x.to(dtype)
    before = tvp.probe.launches
    got = tvp.probe(x, iters)
    ref = tvp.probe_reference(x, iters)
    torch.cuda.synchronize()
    assert tvp.probe.launches == before + 1
    assert got.dtype == dtype and got.shape == x.shape and torch.isfinite(got.float()).all()
    err = (got.float() - ref.float()).abs().max().item()
    top = ref.float().abs().max().item()
    if dtype == torch.float32:
        assert err <= 1e-5 * top
    else:
        assert err <= (1.0 if kind == "ones" else 8 * 2.0 ** (np.floor(np.log2(top)) - 7))


def test_vpu_probe_kernel_raises_on_bad_input(cuda):
    from clearcam_tpu_torch.tools import vpu_probe as tvp
    x = torch.ones((4, 128), device=cuda)
    with pytest.raises(TypeError):
        tvp.probe(x.half(), 8)
    with pytest.raises(ValueError, match=r"\[N, 128\]"):
        tvp.probe(torch.ones((4, 64), device=cuda), 8)
    with pytest.raises(ValueError, match="contiguous"):
        tvp.probe(torch.ones((128, 8), device=cuda).t(), 8)
    with pytest.raises(ValueError, match="multiple of 8"):
        tvp.probe(x, 12)


# ---------------------------------------------------------------------------
# RF-DETR and the measurement, MOT and evaluation tools on the card
# ---------------------------------------------------------------------------

# tests/test_rfdetr.py's TINY config (that file imports jax)
RF_TINY = dict(resolution=64, patch_size=16, vit_dim=32, vit_depth=4, vit_heads=2,
               num_windows=2, global_blocks=(1, 3), out_blocks=(1, 3), d_model=32,
               num_queries=12, dec_layers=2, sa_heads=4, ca_heads=4, ca_points=4,
               mlp_ratio=2, projector_n=1)


def test_rfdetr_tiny_gpu_matches_cpu(cuda):
    """f32, TF32 off: logits and boxes within the forward's CPU bound, the
    proposal indices equal, detect rows under testing's rule."""
    from clearcam_tpu_torch.models import rfdetr
    from clearcam_tpu_torch.testing import detection_mismatches
    cfg = rfdetr.RFDETRConfig(**RF_TINY)
    params = rfdetr.init_params(cfg, seed=0)
    cpu, gpu = rfdetr.params_from_jax(params), rfdetr.params_from_jax(params, cuda)
    x = np.random.default_rng(4).normal(size=(2, 64, 64, 3)).astype(np.float32)
    def run(p, xx):
        taps, hw = rfdetr.backbone_forward(p, xx, cfg)
        _, top, _ = rfdetr.proposals(p, rfdetr.projector_forward(p, taps, hw, cfg), cfg)
        return (*rfdetr.forward(p, xx, cfg), top)

    with torch.inference_mode():
        rl, rb, rt = run(cpu, torch.from_numpy(x))
        gl, gb, gt = run(gpu, torch.from_numpy(x).to(cuda))
    assert (gl.cpu() - rl).abs().max().item() <= 1e-4
    assert (gb.cpu() - rb).abs().max().item() <= 1e-4
    assert torch.equal(gt.cpu(), rt)
    frames = np.random.default_rng(8).integers(0, 255, (2, 96, 128, 3), np.uint8)
    ref = rfdetr.RFDETR(cfg, params, conf_threshold=0.0, device="cpu")(frames)
    got = rfdetr.RFDETR(cfg, params, conf_threshold=0.0)(frames)
    assert got.device.type == "cuda"
    assert detection_mismatches(ref.numpy(), got.cpu().numpy(), conf_threshold=0.0) == []


@pytest.fixture
def one_block_clip(monkeypatch):
    """The tools' CLIP tower cut to one block (the kernel route is the same
    at any depth)."""
    import functools
    monkeypatch.setattr(clip, "init_params",
                        functools.partial(clip.init_params, img_blocks=1, txt_blocks=0))


def test_latency_probe_main_on_the_card(cuda):
    from clearcam_tpu_torch.ops import stem as stem_ops
    from clearcam_tpu_torch.tools import latency_probe
    n0 = stem_ops.stem.launches
    rows = latency_probe.main(["--reps", "2"])
    assert [r["stage"] for r in rows] == ["http_overhead", "device_step", "dispatch_sync",
                                          "upload_1080p", "e2e_single"]
    assert all(r["p50_ms"] > 0 for r in rows[1:])
    assert stem_ops.stem.launches - n0 >= 50


def test_clip_tools_main_on_the_card(cuda, one_block_clip):
    from clearcam_tpu_torch.tools import clip_bench, clip_probe
    n0 = tattn.mha_flash.launches
    rows = clip_bench.main(["--batches", "1,2", "--steps", "1"])
    assert [r["batch"] for r in rows] == [1, 2] and tattn.mha_flash.launches > n0
    rows = clip_probe.main(["--batches", "2", "--steps", "1"])
    launches = {r["stage"]: r["launches"] for r in rows}
    assert launches.pop("full_flash") > 0 and set(launches.values()) == {0}


def test_cotenancy_bench_main_on_the_card(cuda, one_block_clip):
    from clearcam_tpu_torch.tools import cotenancy_bench
    final, launches = cotenancy_bench.main(
        "--blocks 2 --ctx 256 --streams 2 --ticks 12 --crops 1 --vlm-res 64 "
        "--quant int8".split())
    assert final["full"]["summaries_done"] > 0
    assert all(launches[k] > 0 for k in ("stem", "vit_attention", "quant_matmul"))


@pytest.mark.parametrize("detector", ["yolo", "rfdetr"])
def test_mot_and_evaluate_main_on_the_card(cuda, tmp_path, detector):
    cv2 = pytest.importorskip("cv2")
    from clearcam_tpu_torch.tools import evaluate, mot
    vw = cv2.VideoWriter(str(tmp_path / "clip.mp4"), cv2.VideoWriter_fourcc(*"mp4v"), 30,
                         (320, 240))
    rng = np.random.default_rng(1)
    for _ in range(4):
        vw.write(rng.integers(0, 255, (240, 320, 3), np.uint8))
    vw.release()
    count = mot.main([str(tmp_path / "clip.mp4"), "--detector", detector, "--res", "128",
                      "--weights", str(tmp_path / "none")])
    assert count >= 0
    (tmp_path / "ds" / "images").mkdir(parents=True)
    (tmp_path / "ds" / "labels").mkdir()
    for i in range(2):
        cv2.imwrite(str(tmp_path / "ds" / "images" / f"im{i}.jpg"),
                    rng.integers(0, 255, (96, 96, 3), np.uint8))
        (tmp_path / "ds" / "labels" / f"im{i}.txt").write_text("0 0.5 0.5 0.4 0.3\n")
    out = evaluate.main([str(tmp_path / "ds"), "--detector", detector, "--res", "128",
                         "--weights", str(tmp_path / "none")])
    assert out.keys() == {"mAP50", "mAP50-95", "classes"}


# ---------------------------------------------------------------------------
# fine-tuning through the stem kernel, and the exported program's replay
# ---------------------------------------------------------------------------

def test_stem_train_grads_match_plain_on_the_card(cuda):
    """The autograd stem's forward launches the kernel; its four weight
    gradients (and x's) equal the plain version's within 1e-4 of max |g|."""
    x, w1, b1, w2, b2 = (torch.from_numpy(a).to(cuda) for a in _inputs((2, 64, 96, 3), seed=4))
    leaves = [t.requires_grad_() for t in (x, w1, b1, w2, b2)]
    g = torch.randn((2, 16, 24, 32), device=cuda)
    before = tstem.stem.launches
    out = tstem.stem_train(*leaves)
    assert tstem.stem.launches == before + 1
    got = torch.autograd.grad(out, leaves, g)
    ref_out = tstem.stem_reference(*leaves)
    ref = torch.autograd.grad(ref_out, leaves, g)
    assert (out - ref_out).abs().max().item() < 1e-4
    for a, b in zip(got, ref):
        assert (a - b).abs().max().item() <= 1e-4 * b.abs().max().item()


def test_stem_train_reads_updated_weights_on_the_card(cuda):
    x, w1, b1, w2, b2 = (torch.from_numpy(a).to(cuda) for a in _inputs((1, 40, 56, 3), seed=5))
    first = tstem.stem_train(x, w1, b1, w2, b2)
    w2.mul_(1.5)
    b1.add_(0.25)
    second = tstem.stem_train(x, w1, b1, w2, b2)
    assert (second - tstem.stem_reference(x, w1, b1, w2, b2)).abs().max().item() < 1e-4
    assert (second - first).abs().max().item() > 1e-2


def _tiny_dataset(root, n=4, size=96):
    cv2 = pytest.importorskip("cv2")
    (root / "images").mkdir(parents=True)
    (root / "labels").mkdir()
    rng = np.random.default_rng(0)
    for i in range(n):
        img = rng.integers(0, 40, (size, size, 3), np.uint8)
        img[33:62, 19:77] = (40, 180, 240)
        cv2.imwrite(str(root / "images" / f"im{i}.jpg"), img)
        (root / "labels" / f"im{i}.txt").write_text("0 0.5 0.5 0.6 0.3\n")
    return root


@pytest.mark.parametrize("remat", [False, True])
def test_finetune_three_steps_on_the_card(cuda, tmp_path, remat):
    from clearcam_tpu_torch.tools import finetune
    root = _tiny_dataset(tmp_path / "ds")
    before = tstem.stem.launches
    losses = finetune.train(str(root), size="t", res=128, batch=2, steps=3, lr=3e-4,
                            remat=remat, out=str(tmp_path / "ft.safetensors"))
    assert len(losses) == 3 and np.isfinite(losses).all()
    # one launch a step; the rematerialized forward launches again
    assert tstem.stem.launches - before == 3 * (2 if remat else 1)
    model = yolov9.YOLOv9.from_safetensors(tmp_path / "ft.safetensors", size="t", res=128)
    assert model(np.zeros((128, 128, 3), np.uint8)).shape == (300, 6)


def test_detection_loss_gpu_matches_cpu(cuda):
    from clearcam_tpu_torch.models import yolo_loss
    from clearcam_tpu_torch.tools import finetune
    params = yolov9.init_params("t", seed=0)
    rng = np.random.default_rng(0)
    frames = torch.from_numpy(rng.uniform(0, 1, (2, 128, 128, 3)).astype(np.float32))
    boxes = torch.tensor([[[8., 8., 80., 80.], [40., 20., 120., 100.]]] * 2)
    cls = torch.tensor([[1, 3], [2, -1]], dtype=torch.int32)
    losses = [yolo_loss.detection_loss(finetune.train_params(params, dev), frames.to(dev),
                                       boxes.to(dev), cls.to(dev)).item()
              for dev in ("cpu", cuda)]
    assert abs(losses[1] - losses[0]) <= 1e-4 * abs(losses[0])


def test_export_replay_on_the_card(cuda, tmp_path):
    from clearcam_tpu_torch.tools import export
    params = yolov9.init_params("t", seed=0)
    meta = export.export_detector(tmp_path / "det.ccprog", size="t", res=320,
                                  frame_hw=(240, 320), batch=1, params=params)
    assert meta["device"].startswith("cuda")
    rep = export.Replayer(tmp_path / "det.ccprog")
    frames = np.random.default_rng(0).integers(0, 255, (1, 240, 320, 3), np.uint8)
    before = tstem.stem.launches
    out = rep(frames)
    assert tstem.stem.launches == before + 1
    with torch.no_grad():
        eager = yolov9.detect(yolov9.params_from_jax(params, cuda),
                              torch.from_numpy(frames).to(cuda), size="t", res=320)
    np.testing.assert_array_equal(out, eager.cpu().numpy())


def test_bundle_traced_on_the_cpu_replays_on_the_card(cuda, tmp_path):
    """Replayer moves a program traced on another device to the one it is
    asked for (torch.export's move_to_device_pass): the kernel launches."""
    from clearcam_tpu_torch.testing import detection_mismatches
    from clearcam_tpu_torch.tools import export
    params = yolov9.init_params("t", seed=0)
    export.export_detector(tmp_path / "det.ccprog", size="t", res=320, frame_hw=(240, 320),
                           batch=1, params=params, device="cpu")
    frames = np.random.default_rng(0).integers(0, 255, (1, 240, 320, 3), np.uint8)
    on_cpu = export.Replayer(tmp_path / "det.ccprog", device="cpu")(frames)
    rep = export.Replayer(tmp_path / "det.ccprog")
    before = tstem.stem.launches
    out = rep(frames)
    assert tstem.stem.launches == before + 1
    assert detection_mismatches(on_cpu, out) == []


def test_tp_decode_on_the_card_two_gloo_ranks(cuda, tmp_path):
    """Two gloo ranks share the card: the int8-weight tp engine (half the
    heads and KV heads a rank) launches the quant-matmul and batched
    decode-attention kernels on both ranks, at the shard's shapes, and
    decodes the tokens of the one-device engine on the same weights."""
    import torch_parallel_workers as W
    from torch_ranks import run_ranks
    cfg = tllm.TransformerConfig(
        num_blocks=2, dim=256, hidden_dim=512, n_heads=4, n_kv_heads=2, norm_eps=1e-5,
        vocab_size=512, head_dim=128, rope_theta=1e4, rope_dim=128, v_head_dim=128,
        max_context=128, qk_norm=128)
    params = tllm.init_params(cfg, seed=3)
    script = [("submit", [1, 2, 3, 4, 5], 6), ("step", 2), ("submit", [9, 8, 7], 5),
              ("idle",)]
    outs = run_ranks(W.tp_decode_on_card, 2, tmp_path, str(tmp_path / "rdv"), cfg,
                     params, script, init=False)
    for o in outs:
        assert o["kshape"] == (2, 1, 128, 128)
        assert o["quant_linear"] > 0 and o["decode_attention_batch"] > 0
    from clearcam_tpu_torch.serving.engine import ServingEngine
    solo = ServingEngine(tllm.quantize_params_int8({k: v.to(cuda) for k, v in params.items()}),
                         cfg, n_slots=2, state_dtype=torch.bfloat16, use_pallas_decode=True)
    assert outs[0]["tokens"] == W._drive(solo, script)
    solo.close()


def test_ring_attention_shard_on_cuda_nccl_world_one(cuda, tmp_path):
    """ring_attention_shard on CUDA tensors in a one-rank NCCL group equals
    plain causal attention."""
    import torch_parallel_workers as W
    from torch_ranks import run_ranks
    rng = np.random.default_rng(0)
    q, k, v = (rng.normal(size=(2, 64, 4, 32)).astype(np.float32) for _ in range(3))
    o = run_ranks(W.ring_on_card, 1, tmp_path, str(tmp_path / "rdv"), q, k, v,
                  init=False)[0]
    assert o["backend"] == "nccl"
    s = np.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(32)
    s = np.where(np.tril(np.ones((64, 64), bool)), s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    ref = np.einsum("bhqk,bkhd->bqhd", p / p.sum(-1, keepdims=True), v)
    np.testing.assert_allclose(o["out"], ref, rtol=1e-4, atol=1e-4)


def test_stem_and_tunnel_probes_on_the_card(cuda, capsys):
    """tools/stem_kernel_probe holds the kernel against the cuDNN pair within
    the stem's bf16 bound and launches it; tools/stem_probe and
    tools/tunnel_probe time on the card and print its name and the
    kernels a tunnel call launches."""
    import re

    from clearcam_tpu_torch.tools import stem_kernel_probe, stem_probe, tunnel_probe
    n0 = tstem.stem.launches
    argv = ["--batch", "8", "--res", "384", "--steps", "3"]
    r = stem_kernel_probe.main(argv)
    assert r["max_abs_diff"] < 0.05 and r["s2d_layout_ms_unfused"] is None
    assert r["kernel_stem_ms"] > 0 and r["cudnn_stem_ms"] > 0
    assert tstem.stem.launches - n0 == 1 + 2 * 3    # the check, a warm-up of 3, 3 timed
    r = stem_probe.main(argv)
    assert all(r[k] > 0 for k in ("stem_ms", "stem_split_ms", "conv1_ms", "conv2_ms",
                                  "conv1_s2d_2x2s1_ms"))
    r = tunnel_probe.main([])
    assert all(r[k] > 0 for k in ("a_chained_ms", "b_upload_per_call_ms",
                                  "c_lagged_readback_ms", "d_lagged_async_readback_ms"))
    out = capsys.readouterr().out
    assert out.count("# nvidia-smi: ") == 3
    assert int(re.search(r"^# kernel launches a call: (\d+)$", out, re.M).group(1)) >= 1
