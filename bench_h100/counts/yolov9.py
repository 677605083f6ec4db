"""Operations and bytes of the YOLOv9 graphs, worked out from the shapes.

Model operations are the convolutions' multiply-adds, two operations each:
2 * H_out * W_out * C_out * (C_in / groups) * k * k a convolution; pooling,
activations, the DFL head and NMS are left out (under 0.5% of the total).
"""
from __future__ import annotations

from ..reference import yolov9 as ref


def _conv_out(n: int, k: int, s: int) -> int:
    return (n + 2 * (k // 2) - k) // s + 1


def conv_shapes(cfg: dict, h: int, w: int) -> list[tuple]:
    """(name, cin, cout, k, groups, h_out, w_out) of every convolution, for
    a letterboxed input of h x w pixels."""
    specs = {s[0]: s for s in ref.conv_specs(cfg)}
    out = []
    shapes: list = []          # (c, h, w) of each layer's output

    def cv(pre, hw):
        _, cin, cout, k, s, groups, _ = specs[pre]
        ho, wo = _conv_out(hw[0], k, s), _conv_out(hw[1], k, s)
        out.append((pre, cin, cout, k, groups, ho, wo))
        return cout, ho, wo

    def repncsp(pre, hw, n):
        for i in range(n):
            cv(f"{pre}.m.{i}.cv1.conv", hw)
            cv(f"{pre}.m.{i}.cv2.conv", hw)
        for name in (".cv1.conv", ".cv2.conv", ".cv3.conv"):
            c = cv(pre + name, hw)[0]
        return c

    cur = (3, h, w)
    for idx, (kind, src, args) in enumerate(ref.graph_of(cfg)):
        pre = f"model.{idx}"
        if src != -1:
            ins = [shapes[src]] if isinstance(src, int) else \
                [cur if j == -1 else shapes[j] for j in src]
        else:
            ins = [cur]
        hw = ins[0][1:]
        if kind == "conv":
            cur = cv(pre + ".conv", hw)
        elif kind == "aconv":
            cur = cv(pre + ".cv1.conv", (hw[0] - 1, hw[1] - 1))
        elif kind == "adown":
            p = (hw[0] - 1, hw[1] - 1)
            c1, ho, wo = cv(pre + ".cv1.conv", p)
            c2 = cv(pre + ".cv2.conv", (_conv_out(p[0], 3, 2), _conv_out(p[1], 3, 2)))[0]
            cur = (c1 + c2, ho, wo)
        elif kind == "elan1":
            cv(pre + ".cv1.conv", hw)
            cv(pre + ".cv2.conv", hw)
            cv(pre + ".cv3.conv", hw)
            cur = cv(pre + ".cv4.conv", hw)
        elif kind == "repncspelan4":
            cv(pre + ".cv1.conv", hw)
            repncsp(pre + ".cv2.0", hw, args["n"])
            cv(pre + ".cv2.1.conv", hw)
            repncsp(pre + ".cv3.0", hw, args["n"])
            cv(pre + ".cv3.1.conv", hw)
            cur = cv(pre + ".cv4.conv", hw)
        elif kind == "sppelan":
            cv(pre + ".cv1.conv", hw)
            cur = cv(pre + ".cv5.conv", hw)
        elif kind == "upsample":
            cur = (ins[0][0], hw[0] * 2, hw[1] * 2)
        elif kind == "concat":
            cur = (sum(s[0] for s in ins), *hw)
        elif kind == "ddetect":
            for i, f in enumerate(ins):
                for name in (".0.conv", ".1.conv", ".2"):
                    cv(f"{pre}.cv2.{i}{name}", f[1:])
                    cv(f"{pre}.cv3.{i}{name}", f[1:])
            cur = None
        shapes.append(cur)
    return out


def conv_flops(shape) -> float:
    _, cin, cout, k, groups, ho, wo = shape
    return 2.0 * ho * wo * cout * (cin // groups) * k * k


def frame_flops(cfg: dict, src_h: int, src_w: int, res: int) -> float:
    """Model operations of one frame of src_h x src_w letterboxed to res."""
    _, _, _, _, h, w = ref.letterbox_geometry(src_h, src_w, res)
    return sum(conv_flops(s) for s in conv_shapes(cfg, h, w))


def stem_cost(cfg: dict, batch: int, h: int, w: int, act_bytes: int = 2) -> tuple[float, float]:
    """(bytes, operations) of one call of the fused stem (layers 0 and 1) on
    a [batch, h, w, 3] letterboxed input: the input read once, layer 1's
    output written once, both filters and biases read once (bf16 filters,
    f32 biases); operations of both convolutions. Layer 0's output never
    leaves the kernel."""
    shapes = conv_shapes(cfg, h, w)[:2]
    ops = batch * sum(conv_flops(s) for s in shapes)
    (_, cin0, c0, k0, _, _, _), (_, _, c1, k1, _, ho, wo) = shapes
    weights = (k0 * k0 * cin0 * c0 + k1 * k1 * c0 * c1) * act_bytes + (c0 + c1) * 4
    nbytes = batch * (h * w * cin0 + ho * wo * c1) * act_bytes + weights
    return float(nbytes), float(ops)
