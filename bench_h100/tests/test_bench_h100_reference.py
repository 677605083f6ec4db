"""Each plain reference against the program, at a tiny size on the CPU."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from bench_h100 import compare, weights
from bench_h100.reference import qwen3 as ref_qwen
from bench_h100.reference import yolov9 as ref_yolo

PKG = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(min(4, before))
    yield
    torch.set_num_threads(before)


def test_weight_names_and_shapes_are_the_programs():
    from clearcam_tpu_torch.models import yolov9
    cfg = json.loads((PKG / "configs" / "yolov9-t.json").read_text())
    frame = np.zeros((72, 128, 3), np.uint8)
    mine = weights.yolov9(cfg, 3, torch.device("cpu"), frame)
    theirs = yolov9.init_params("t")
    assert {k: v.shape for k, v in mine.items()} == {k: v.shape for k, v in theirs.items()}


@pytest.mark.parametrize("hw", [(96, 160), (72, 128)])
def test_yolov9_reference_against_the_program(hw):
    from clearcam_tpu_torch.models import yolov9
    cfg = json.loads((PKG / "configs" / "yolov9-t.json").read_text())
    cfg["init"]["class_bias"] = -1.0         # live rows among the 84 anchors at 64 px
    frames = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, *hw, 3), np.uint8))
    w = weights.yolov9(cfg, 11, torch.device("cpu"), frames[0].numpy())
    p = yolov9.params_from_jax(w, "cpu", torch.float32)
    got = yolov9.detect(p, frames, size="t", res=64).numpy()
    rows, kept, boxes, probs = ref_yolo.detect(ref_yolo.Model(cfg, w, "cpu"), frames, 64)
    for i in range(2):
        g = compare.detect_gaps(got[i], kept[i], boxes[i], probs[i], hw)
        assert g["ref_kept"] > 0 and g["box_gap_px"] < 1e-3 and g["score_gap"] < 1e-5
        assert g["kept_diff"] == 0 and g["live"] == g["ref_kept"]
        np.testing.assert_allclose(got[i], rows[i].numpy(), atol=2e-3)


def _tiny_hf():
    hf = json.loads((PKG / "configs" / "qwen3-1.7b-int8.json").read_text())
    hf.update(hidden_size=256, num_hidden_layers=2, num_attention_heads=4,
              num_key_value_heads=2, head_dim=128, intermediate_size=512, vocab_size=1024)
    hf["serving"]["cache_positions"] = 128
    return hf


@pytest.mark.parametrize("bits", [8, 16])
def test_qwen3_reference_against_the_program(bits):
    from clearcam_tpu_torch.models import llm
    from bench_h100.drivers.serve import transformer_config
    hf = _tiny_hf()
    cfg = transformer_config(llm, hf)
    w = {k: v.float() for k, v in weights.llm(hf, 5, torch.device("cpu")).items()}
    p = llm.quantize_params_int8(w) if bits == 8 else w
    toks = list(np.random.default_rng(1).integers(1, 1023, 40))
    state = llm.init_state(cfg, 1, dtype=torch.float32)
    hidden, _ = llm.forward(p, cfg, state, torch.tensor([toks]), 0, llm.freqs_for(cfg, "cpu"))
    from clearcam_tpu_torch.nn import functional as F
    got = F.linear(F.rms_norm(hidden[0], p["output_norm.weight"], cfg.norm_eps),
                   p["output.weight"])
    want = ref_qwen.Model(hf, w, weight_bits=bits).logits(toks, list(range(40)))
    assert torch.allclose(got, want, atol=2e-4 * want.abs().max())
    assert compare.logit_gap(want, got.argmax(-1)) == 0.0
