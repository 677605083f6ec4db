"""Traffic is the same for the same seed and within its stated ranges."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from bench_h100.traffic import cameras, requests

PKG = Path(__file__).resolve().parents[1]
SEEDS = [7, 2 ** 31 + 9]


@pytest.mark.parametrize("mix_name", ["chat-decode", "docs-prefill"])
@pytest.mark.parametrize("seed", SEEDS)
def test_requests_by_seed_and_range(mix_name, seed):
    mix = json.loads((PKG / "traffic" / f"{mix_name}.json").read_text())
    a, b = requests.make(mix, seed, 151936), requests.make(mix, seed, 151936)
    n = 3 * mix["round"]
    la = [a.lengths(i) for i in range(n)]
    assert la == [b.lengths(i) for i in range(n)]
    assert a.prompt(5) == b.prompt(5) and len(a.prompt(5)) == la[5][0]
    p, o = np.array(la).T
    assert p.min() >= mix["prompt"]["min"] and p.max() <= mix["prompt"]["max"]
    assert o.min() >= mix["output"]["min"] and o.max() <= mix["output"]["max"]
    toks = np.array(a.prompt(0))
    assert toks.min() >= 1 and toks.max() < 151936 - 1
    # every seed: the same sizes in the same order, other tokens; each
    # round holds every quantile once
    other = requests.make(mix, seed + 1, 151936)
    assert la == [other.lengths(i) for i in range(n)]
    assert a.prompt(5) != other.prompt(5)
    r = mix["round"]
    for k in range(3):
        assert sorted(x[0] for x in la[k * r:(k + 1) * r]) == list(a.prompt_q)
        assert sorted(x[1] for x in la[k * r:(k + 1) * r]) == list(a.output_q)
    assert la[:r] != la[r:2 * r]


def test_lognormal_quantiles_in_range_and_median():
    q = requests.quantiles({"dist": "lognormal", "median": 640, "sigma": 0.6,
                            "min": 256, "max": 2048}, 33)
    assert q.min() >= 256 and q.max() <= 2048 and q[16] == 640
    assert list(q) == sorted(q)


def test_cameras_by_seed_and_shape():
    mix = {"generator": "cameras", "pool_frames": 2, "shapes_per_frame": 3,
           "objects_per_camera": 8, "track_ticks": 10,
           "groups": [{"cameras": 2, "height": 72, "width": 128},
                      {"cameras": 1, "height": 48, "width": 64}]}
    a = cameras.make(mix, SEEDS[1], torch.device("cpu"))
    b = cameras.make(mix, SEEDS[1], torch.device("cpu"))
    c = cameras.make(mix, SEEDS[0], torch.device("cpu"))
    assert a.n_cams == 3
    assert [f.shape for f in a.frames_at(3)] == [(72, 128, 3), (72, 128, 3), (48, 64, 3)]
    assert all(f.dtype == np.uint8 for f in a.frames_at(0))
    for t in range(4):
        assert all(np.array_equal(x, y) for x, y in zip(a.frames_at(t), b.frames_at(t)))
        assert all(np.array_equal(a.tracks_at(t)[k], b.tracks_at(t)[k]) for k in range(3))
    assert not np.array_equal(a.frames_at(0)[0], c.frames_at(0)[0])
    rows = a.tracks_at(4)[1]
    assert rows.shape == (8, 6) and (rows[:, 2] > rows[:, 0]).all() and (rows[:, 4] == 0.8).all()
