"""YOLOv9 fine-tuning in the port (clearcam_tpu_torch.models.yolo_loss,
tools/finetune.py, the autograd stem) against the JAX package's, on the CPU
in float32 with the same numpy weights and inputs: the loss and every
leaf's gradient, the TAL targets, two optimizer steps, the dataset loader,
and the published output read back by both packages. The CUDA stem under
autograd and a finetune on the card are in test_torch_port_cuda.py."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clearcam_tpu.models import yolo_loss as JL
from clearcam_tpu.models import yolov9 as J
from clearcam_tpu.tools import finetune as JF
from clearcam_tpu_torch.models import yolo_loss as TL
from clearcam_tpu_torch.models import yolov9 as T
from clearcam_tpu_torch.nn import functional as tF
from clearcam_tpu_torch.ops import stem as tstem
from clearcam_tpu_torch.testing import compared_rows, detection_mismatches, torch_threads
from clearcam_tpu_torch.tools import finetune as TF

cv2 = pytest.importorskip("cv2")


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    with torch_threads(2):
        yield


def make_dataset(root, n=6, size=96):
    """tests/test_finetune.py's synthetic YOLO-format set: one bright box."""
    (root / "images").mkdir(parents=True)
    (root / "labels").mkdir()
    rng = np.random.default_rng(0)
    for i in range(n):
        img = rng.integers(0, 40, (size, size, 3), np.uint8)
        cx, cy, w, h = 0.5, 0.5, 0.4, 0.3
        x1, y1 = int((cx - w / 2) * size), int((cy - h / 2) * size)
        x2, y2 = int((cx + w / 2) * size), int((cy + h / 2) * size)
        img[y1:y2, x1:x2] = (240, 180, 40)
        cv2.imwrite(str(root / "images" / f"im{i}.jpg"), img[:, :, ::-1])
        (root / "labels" / f"im{i}.txt").write_text(f"0 {cx} {cy} {w} {h}\n")
    return root


def _batch(res=64, seed=0):
    """Two letterboxed frames, GT boxes with a padded row (class -1)."""
    rng = np.random.default_rng(seed)
    frames = rng.uniform(0, 1, (2, res, res, 3)).astype(np.float32)
    boxes = np.array([[[8, 8, 40, 40], [20, 10, 60, 50], [0, 0, 0, 0]],
                      [[4, 30, 30, 62], [36, 4, 60, 28], [10, 10, 50, 50]]], np.float32)
    cls = np.array([[1, 3, -1], [2, 0, 5]], np.int32)
    return frames, boxes, cls


def _torch_batch(frames, boxes, cls):
    return torch.from_numpy(frames), torch.from_numpy(boxes), torch.from_numpy(cls)


def _hwio(name, g):
    return tF.oihw_to_hwio(g).numpy() if g.ndim == 4 else g.numpy()


@pytest.mark.parametrize("size", ["dryrun", "t"])
def test_detection_loss_and_grads_match_jax(size):
    params = J.init_params(size, seed=0)
    frames, boxes, cls = _batch()
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: JL.detection_loss(p, frames, boxes, cls, size=size)))(params)
    tp = TF.train_params(params, "cpu")
    assert not tp.keys() & set(T.STEM_PACKED_KEYS)
    tloss = TL.detection_loss(tp, *_torch_batch(frames, boxes, cls), size=size)
    tgrads = torch.autograd.grad(tloss, list(tp.values()))
    assert abs(tloss.item() - float(loss)) <= 1e-5 * abs(float(loss))
    assert tp.keys() == params.keys()
    for (k, _), g in zip(tp.items(), tgrads):
        ref = np.asarray(grads[k])
        assert np.abs(_hwio(k, g) - ref).max() <= 1e-3 * np.abs(ref).max(), k
    # the stem's four weights get their gradient through the training route
    for src in T.STEM_KEYS.values():
        assert np.abs(np.asarray(grads[src])).max() > 0, src


def test_saturated_scores_keep_the_loss_finite():
    """A class score that saturates to 1.0 in float32: the JAX loss clips
    at 1 - EPS, which is 1.0, and is infinite; the port clips at the
    largest float32 below 1, so its loss and gradients stay finite."""
    params = J.init_params("dryrun", seed=0)
    params["model.5.cv3.0.2.bias"] = np.full(80, 40.0, np.float32)   # sigmoid(40) == 1.0
    frames, boxes, cls = _batch()
    assert np.isinf(float(JL.detection_loss(params, frames, boxes, cls, size="dryrun")))
    tp = TF.train_params(params, "cpu")
    loss = TL.detection_loss(tp, *_torch_batch(frames, boxes, cls), size="dryrun")
    grads = torch.autograd.grad(loss, list(tp.values()))
    assert torch.isfinite(loss) and all(torch.isfinite(g).all() for g in grads)
    assert np.float32(TL.P_MAX) == np.nextafter(np.float32(1), np.float32(0))


def test_assign_matches_jax():
    """TAL targets from one head output: per image as the JAX function
    takes it, and batched (the port's leading dimension) the same."""
    params = J.init_params("dryrun", seed=0)
    frames, boxes, cls = _batch()
    raw = np.array(J.forward_raw(params, jnp.asarray(frames), "dryrun"))
    anchors, strides = J._make_anchors([(64 // s, 64 // s) for s in J.STRIDES])
    anchor_px = anchors * strides[:, None]
    got = TL.assign(torch.from_numpy(raw), torch.from_numpy(boxes),
                    torch.from_numpy(cls), torch.from_numpy(anchor_px))
    for b in range(2):
        ref = [np.asarray(a) for a in JL.assign(raw[b], boxes[b], cls[b], anchor_px)]
        one = TL.assign(torch.from_numpy(raw[b]), torch.from_numpy(boxes[b]),
                        torch.from_numpy(cls[b]), torch.from_numpy(anchor_px))
        for r, g1, gb in zip(ref, one, got):
            np.testing.assert_array_equal(g1.numpy(), gb[b].numpy())
            if r.dtype == bool:
                np.testing.assert_array_equal(g1.numpy(), r)
            else:
                np.testing.assert_allclose(g1.numpy(), r, rtol=1e-5, atol=0)
        assert ref[2].any()         # the boxes claimed anchors


def test_assign_ignores_padded_gt_and_anchors_outside():
    """tests/test_yolo_loss.py's synthetic case, through the port."""
    anchors = np.stack(np.meshgrid(np.arange(8) * 8 + 4,
                                   np.arange(8) * 8 + 4), -1).reshape(-1, 2)
    pred = np.zeros((64, 8), np.float32)
    pred[:, 0:2] = anchors
    pred[:, 2:4] = 10.0
    pred[:, 4] = 0.5
    gt = torch.tensor([[8.0, 8.0, 32.0, 32.0]])
    a = torch.from_numpy(anchors.astype(np.float32))
    _, box_t, fg = TL.assign(torch.from_numpy(pred), gt, torch.tensor([0]), a)
    inside = ((anchors[:, 0] > 8) & (anchors[:, 0] < 32)
              & (anchors[:, 1] > 8) & (anchors[:, 1] < 32))
    assert fg.any() and not fg.numpy()[~inside].any()
    assert box_t[fg][0].tolist() == [8, 8, 32, 32]
    assert not TL.assign(torch.from_numpy(pred), gt, torch.tensor([-1]), a)[2].any()


@pytest.fixture(scope="module")
def jax_two_steps():
    params = J.init_params("dryrun", seed=0)
    step, opt = JL.make_finetune_step("dryrun", lr=1e-3, clip_norm=1.0)
    state, p, losses = opt.init(params), params, []
    for _ in range(2):
        p, state, loss = step(p, state, *_batch())
        losses.append(float(loss))
    return params, p, losses


@pytest.mark.parametrize("remat", [False, True])
def test_finetune_steps_match_jax(jax_two_steps, remat):
    """Two clipped-AdamW steps: the losses, and every parameter within
    Adam's sign bound (lr a step, twice over) of JAX's."""
    params, ref, ref_losses = jax_two_steps
    lr = 1e-3
    step, opt = TL.make_finetune_step("dryrun", lr=lr, clip_norm=1.0, remat=remat)
    tp = TF.train_params(params, "cpu")
    state, losses = opt.init(tp), []
    for _ in range(2):
        tp, state, loss = step(tp, state, *_torch_batch(*_batch()))
        losses.append(loss.item())
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4)
    got = TF.hwio_params(tp)
    for k in params:
        assert np.abs(got[k] - np.asarray(ref[k])).max() <= 2 * lr * 2, k
    assert state.param_groups[0]["weight_decay"] == 1e-4     # optax.adamw's


def test_clip_rule_is_optax():
    """Scaled by c / norm only when the global norm reaches c."""
    opt = TL._Optimizer(1e-3, clip_norm=1.0)
    small = [torch.tensor([0.3, 0.4])]
    opt.clip(small)
    assert small[0].tolist() == pytest.approx([0.3, 0.4])
    big = [torch.tensor([3.0, 0.0]), torch.tensor([[4.0]])]
    opt.clip(big)
    assert big[0].tolist() == pytest.approx([0.6, 0.0]) and big[1].item() == pytest.approx(0.8)


def test_stem_train_gradcheck():
    """The autograd stem in float64 through its plain forward (the CPU
    route) against finite differences, every input."""
    rng = np.random.default_rng(0)
    shapes = [(2, 12, 10, 3), (3, 3, 3, 16), (16,), (3, 3, 16, 32), (32,)]
    scales = [1.0, 0.2, 0.1, 0.1, 0.1]
    args = [torch.from_numpy(rng.standard_normal(s) * c).requires_grad_()
            for s, c in zip(shapes, scales)]
    assert torch.autograd.gradcheck(tstem.stem_train, args)
    before = tstem.stem.launches
    tstem.stem_train(*args).sum().backward()
    assert tstem.stem.launches == before        # the CPU route launches nothing


def test_training_route_reads_the_live_weights():
    """forward_raw(train=True) runs the stem on model.{0,1} as they are
    now (an optimizer step's update shows), not on the packed copies."""
    params = J.init_params("dryrun", seed=0)
    x = torch.from_numpy(np.random.default_rng(1).uniform(0, 1, (1, 64, 64, 3))
                         .astype(np.float32))
    tp = T.params_from_jax(params, "cpu")
    before = T.forward_raw(tp, x, "dryrun", train=True)
    np.testing.assert_array_equal(before.detach().numpy(),
                                  T.forward_raw(tp, x, "dryrun").numpy())
    with torch.no_grad():
        tp["model.1.conv.weight"] *= 1.5         # the packed stem.w2 stays
    after = T.forward_raw(tp, x, "dryrun", train=True)
    assert (after - before).abs().max().item() > 1e-3
    np.testing.assert_array_equal(T.forward_raw(tp, x, "dryrun").numpy(),
                                  before.detach().numpy())


def test_training_after_detect_in_one_process():
    """The anchors a detect step caches (under inference mode) serve a
    training step of the same feature shapes: autograd can save them."""
    params = J.init_params("dryrun", seed=0)
    T._anchors_on.cache_clear()
    T.YOLOv9("dryrun", res=64, params=params, device="cpu")(np.zeros((64, 64, 3), np.uint8))
    tp = TF.train_params(params, "cpu")
    TL.detection_loss(tp, *_torch_batch(*_batch()), size="dryrun").backward()
    assert all(v.grad is not None for v in tp.values())


def test_load_dataset_matches_jax(tmp_path):
    root = make_dataset(tmp_path, n=3, size=96)
    (root / "images" / "wide.png").write_bytes(
        cv2.imencode(".png", np.full((40, 96, 3), 90, np.uint8))[1].tobytes())
    (root / "labels" / "wide.txt").write_text("2 0.25 0.5 0.2 0.4\n5 0.7 0.5 0.1 0.2\n")
    for ref, got in zip(JF.load_dataset(root, res=64), TF.load_dataset(root, res=64)):
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)


def test_train_descends_and_output_loads_in_both_packages(tmp_path):
    root = make_dataset(tmp_path / "ds", n=4, size=96)
    out = tmp_path / "ft.safetensors"
    losses = TF.train(str(root), size="t", res=64, batch=4, steps=14, lr=3e-4,
                      clip_norm=1.0, out=str(out), log_every=6, device="cpu")
    assert len(losses) == 14 and losses[-1] < losses[0], losses
    frames = np.random.default_rng(2).integers(0, 256, (2, 96, 128, 3), np.uint8)
    ref = np.asarray(J.YOLOv9.from_safetensors(out, size="t", res=64)(jnp.asarray(frames)))
    model = T.YOLOv9.from_safetensors(out, size="t", res=64, device="cpu")
    got = model(frames).numpy()
    assert detection_mismatches(ref, got) == [] and np.isfinite(got).all()
    assert compared_rows(ref) > 0
    # the module holds the trained weights, and its packed stem operands
    # were made from them
    trained = model.flat_params()
    np.testing.assert_array_equal(trained["stem.b2"].numpy(),
                                  trained["model.1.conv.bias"].numpy())


def test_checkpoint_resume(tmp_path):
    """tests/test_finetune.py's case: 6 steps checkpointed every 3, then a
    second run resumes at step 6 and continues to 9."""
    root = make_dataset(tmp_path / "ds", n=4, size=96)
    ck = tmp_path / "ck"
    losses1 = TF.train(str(root), size="t", res=64, batch=4, steps=6, lr=3e-4,
                       out=str(tmp_path / "a.safetensors"), log_every=3,
                       ckpt_dir=str(ck), ckpt_every=3, device="cpu")
    assert (ck / "state").exists() and not (ck / "state.new").exists()
    state = torch.load(ck / "state", weights_only=True)
    assert state["step"] == 6 and state["opt_state"]["state"]
    losses2 = TF.train(str(root), size="t", res=64, batch=4, steps=9, lr=3e-4,
                       out=str(tmp_path / "b.safetensors"), log_every=3,
                       ckpt_dir=str(ck), ckpt_every=3, device="cpu")
    assert len(losses1) == 6 and len(losses2) == 3    # resumed at step 6
    assert losses2[0] < losses1[0]
    assert torch.load(ck / "state", weights_only=True)["step"] == 9


def test_main_prints_its_summary_and_refuses_mesh(tmp_path, capsys):
    """The ``# finetune`` line; then ``--mesh 2 --device cpu``: this process
    leads 2 gloo ranks it starts itself on a (1, 2) mesh, and the written
    parameters after 2 steps equal the one-device run's within 1e-5
    relative (the step's losses: tests/test_torch_port_parallel_tp.py).
    ``--mesh`` with no count and no card is refused."""
    from clearcam_tpu_torch.io import safetensors as st
    root = make_dataset(tmp_path / "ds", n=2, size=96)
    solo = TF.train(str(root), res=64, batch=2, steps=2, device="cpu",
                    out=str(tmp_path / "solo.safetensors"))
    TF.main([str(root), "--res", "64", "--batch", "2", "--steps", "2",
             "--device", "cpu", "--out", str(tmp_path / "o.safetensors"),
             "--mesh", "2"])
    line = [x for x in capsys.readouterr().out.splitlines() if x.startswith("# finetune ")]
    summary = json.loads(line[-1][len("# finetune "):])
    assert summary["steps"] == 2 and summary["stem_launches"] == 0
    assert summary["device"] == "cpu" and summary["peak_bytes"] is None
    assert summary["mesh"] == {"data": 1, "model": 2}
    a, b = st.load(tmp_path / "o.safetensors"), st.load(tmp_path / "solo.safetensors")
    keys = sorted(b)
    va = np.concatenate([np.ravel(a[k]) for k in keys]).astype(np.float64)
    vb = np.concatenate([np.ravel(b[k]) for k in keys]).astype(np.float64)
    assert np.linalg.norm(va - vb) <= 1e-5 * np.linalg.norm(vb)
    assert len(solo) == 2
    with pytest.raises(SystemExit, match="rank count"):
        TF.train(str(root), use_mesh=True, device="cpu")


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        TF.train("unused")
