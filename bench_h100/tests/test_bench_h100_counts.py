"""Operation and byte counts against hand counts."""
import json
from pathlib import Path

import pytest

from bench_h100.counts import bounds, qwen3, yolov9

PKG = Path(__file__).resolve().parents[1]
YOLO = json.loads((PKG / "configs" / "yolov9-t.json").read_text())
QWEN = json.loads((PKG / "configs" / "qwen3-1.7b-int8.json").read_text())


@pytest.mark.parametrize("h,w,l0,l1", [
    # 2 * Ho * Wo * Cout * Cin * 9 for conv 3->16 s2 and 16->32 s2
    (384, 640, 2 * 192 * 320 * 16 * 27, 2 * 96 * 160 * 32 * 144),
    (640, 640, 2 * 320 * 320 * 16 * 27, 2 * 160 * 160 * 32 * 144)])
def test_stem_convs(h, w, l0, l1):
    s = yolov9.conv_shapes(YOLO, h, w)
    assert [yolov9.conv_flops(x) for x in s[:2]] == [l0, l1]


def test_yolov9_t_total_is_the_published_7_7_gflop():
    total = sum(yolov9.conv_flops(x) for x in yolov9.conv_shapes(YOLO, 640, 640))
    assert abs(total / 7.7e9 - 1) < 0.01
    # a 1080p frame letterboxes to 384 x 640: 3/5 of the square's work
    assert yolov9.frame_flops(YOLO, 1080, 1920, 640) == pytest.approx(total * 0.6, rel=1e-3)


@pytest.mark.parametrize("b,nbytes", [
    (1, 384 * 640 * 3 * 2 + 96 * 160 * 32 * 2 + (27 * 16 + 144 * 32) * 2 + 48 * 4),
    (32, 32 * (384 * 640 * 3 * 2 + 96 * 160 * 32 * 2) + (27 * 16 + 144 * 32) * 2 + 48 * 4)])
def test_stem_bytes(b, nbytes):
    got_bytes, ops = yolov9.stem_cost(YOLO, b, 384, 640)
    assert got_bytes == nbytes
    assert ops == b * (2 * 192 * 320 * 16 * 27 + 2 * 96 * 160 * 32 * 144)


@pytest.mark.parametrize("rows,o,k,nbytes", [
    (8, 6144, 2048, 6144 * 2048 + 4 * 6144 + 8 * 2048 * 4 + 8 * 6144 * 4),
    # the vocabulary pads to 152064 rows of int8
    (32, 151936, 2048, 152064 * 2048 + 4 * 152064 + 32 * 2048 * 4 + 32 * 151936 * 4)])
def test_quant_matmul_cost(rows, o, k, nbytes):
    assert qwen3.qm_cost(rows, o, k) == (nbytes, 2.0 * rows * o * k)


def test_decode_call_flops_and_attention_bytes():
    import numpy as np
    meta = np.array([[0, 9, 5], [1, 1, 0], [0, 0, 0], [0, 0, 0], [0, 0, 0]])
    dense = 2 * 28 * (2048 * 2048 * 2 + 1024 * 2048 * 2 + 6144 * 2048 * 3)
    attn = 4 * 28 * 16 * 128
    head = 2 * 2048 * 151936
    want = (dense + attn * 1 + head) + (dense + attn * 10 + head)     # live rows only
    assert qwen3.model_flops(QWEN, [("decode", meta)]) == pytest.approx(want)
    kv = (1 + 10 + 6) * 8 * 128 * 2 * 2 + 2 * 3 * 16 * 128 * 4
    assert qwen3.decode_attn_bound_s(QWEN, [("decode", meta)]) == pytest.approx(
        28 * kv / bounds.HBM)


def test_prefill_flops_count_real_tokens():
    import numpy as np
    meta = np.array([[64, 0], [32, 7], [1, 0], [0, 0]])   # start, n_real, valid, seed
    dense = 2 * 28 * (2048 * 2048 * 2 + 1024 * 2048 * 2 + 6144 * 2048 * 3)
    attn = 4 * 28 * 16 * 128 * sum(p + 1 for p in range(64, 96))
    want = dense * 32 + attn + 2 * 2048 * 151936
    assert qwen3.model_flops(QWEN, [("prefill_many", meta)]) == pytest.approx(want)


def test_bound_picks_the_larger():
    t, by = bounds.bound(3.35e12, 1.0, 1e12)
    assert (t, by) == (1.0, "bytes")
    t, by = bounds.bound(1.0, 989e12, bounds.PEAK["bfloat16"])
    assert (t, by) == (1.0, "operations")
