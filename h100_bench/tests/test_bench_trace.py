"""The reduction of a profiler session (``trace.reduce``) on a made-up
session: busy time and idle gaps over the host's span from the second
step on, gaps named by the host span that overlaps them most, operations
and span kernel time a step, and the whole-session rule."""

from types import SimpleNamespace

import torch

from h100_bench import trace

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


def ev(name, start, end, device=CUDA, annotation=False):
    tr = SimpleNamespace(start=start, end=end, elapsed_us=lambda: end - start)
    return SimpleNamespace(name=name, device_type=device, time_range=tr, is_user_annotation=annotation)


def session(drop_one=False):
    evs = []
    for k in range(3):  # three steps of 100 us: acquire's kernel, then a copy
        t = 100 * k
        evs += [ev("span:step", t, t + 100, CPU), ev("span:acquire", t, t + 40, CPU),
                ev("span:acquire", t + 5, t + 30, CUDA, True), ev("k1", t + 10, t + 30),
                ev("nccl:all_gather", t + 40, t + 60, CUDA, True), ev("copy", t + 60, t + 70)]
    if drop_one:
        evs = [e for e in evs if not (e.name == "copy" and e.time_range.start == 260)]
    return SimpleNamespace(events=lambda: evs)


def test_reduce_busy_gaps_and_kernels():
    r = trace.reduce(torch, session(), 3)
    assert r["whole"] and r["ops_per_step"] == 2
    assert r["window_s"] == 200e-6 and r["busy_s"] == 60e-6  # steps 2 and 3: 30 us each
    assert r["span_kernel_s"]["acquire"] == 20e-6 and r["kernel_s"]["copy"] == 10e-6
    # gaps: 100-110 wholly in acquire's span; 130-160, 170-210, 230-260
    # and 270-300 mostly in the step outside any span inside it
    assert r["idle_gaps"] == [["step", 40e-6], ["step", 30e-6], ["step", 30e-6], ["step", 30e-6],
                              ["acquire", 10e-6]]
    assert trace.kernel_s(r, "k1") == 20e-6 and trace.kernel_s(r, "nccl") is None


def test_reduce_flags_dropped_records():
    r = trace.reduce(torch, session(drop_one=True), 3)
    assert not r["whole"] and trace.kernel_s(r, "k1") is None
