"""The clock the harness maps the card's trace onto is the program's: a
kernel launched inside a program span (``clearcam_tpu_torch.runtime.metrics``)
lies inside it in the trace as ``Tracer`` and ``Trace.from_profile`` map it,
and a host-only span lies inside the card's idle gap, each within 0.2 ms.
Needs the card:

    python -m pytest -q -s -p no:cacheprovider bench_h100/tests/test_bench_h100_clock.py
"""
import time

import pytest
import torch

from bench_h100 import harness

TOL_S = 0.2e-3


@pytest.mark.cuda
def test_program_spans_share_the_trace_clock():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from clearcam_tpu_torch.runtime.metrics import Metrics
    reg = Metrics()
    x = torch.zeros(1024, device="cuda")
    cycles = int(5e-3 * torch.cuda.get_device_properties(0).clock_rate * 1e3) \
        if hasattr(torch.cuda.get_device_properties(0), "clock_rate") else 10_000_000
    torch.cuda._sleep(1000)                # warm the launch path
    x.add_(1)
    torch.cuda.synchronize()
    tracer = harness.Tracer(10.0, enabled=True)
    now = time.perf_counter()
    tracer.poll(now, now, 10.0)
    time.sleep(0.05)
    with reg.timer("clock.kernel"):
        torch.cuda._sleep(cycles)
        torch.cuda.synchronize()
    with reg.timer("clock.idle"):
        time.sleep(0.02)
    x.add_(1)                              # closes the card's idle gap
    torch.cuda.synchronize()
    tracer.stop()
    tr = tracer.result
    (kspan,) = reg.spans("clock.kernel")
    (ispan,) = reg.spans("clock.idle")
    sleeps = [o for o in tr.kernels() if "spin" in o[0] or "sleep" in o[0].lower()]
    assert len(sleeps) == 1, [o[0] for o in tr.ops]
    _, k0, k1 = sleeps[0]
    after = sorted(a for _, a, _ in tr.ops if a > k1)
    assert after, "no device operation after the idle span"
    g0, g1 = k1, after[0]
    print(f"\nsleep kernel {1e3 * (k1 - k0):.3f} ms: starts {1e3 * (k0 - kspan.start_s):.4f} ms "
          f"after its span's start, ends {1e3 * (kspan.end_s - k1):.4f} ms before its end; "
          f"idle gap {1e3 * (g1 - g0):.3f} ms: opens {1e3 * (ispan.start_s - g0):.4f} ms "
          f"before the host span, closes {1e3 * (g1 - ispan.end_s):.4f} ms after it")
    assert k1 - k0 > 1e-3
    assert k0 >= kspan.start_s - TOL_S and k1 <= kspan.end_s + TOL_S
    assert g0 <= ispan.start_s + TOL_S and g1 >= ispan.end_s - TOL_S
