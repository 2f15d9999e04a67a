"""``chip_smoke.py``'s profile retake (``whole_profile``) and its kernel
names (``kernel_name``), on the CPU.

``whole_profile`` takes ``torch.profiler`` over a body again while the
trace holds no device event, or none of a kind whose launch count rose,
and says how many counted launches the trace it returns lacks.  Here the
CPU's operator events stand in for the card's kernels (the ``torch``
handed to it names the CPU as its device type), and a body that issues
fewer ``aten::mul`` than it counts plays a trace that lost a kernel's
events.
"""

import importlib.util
import os
import types

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_under_test", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cpu_as_device():
    """A ``torch`` whose device events are the CPU's operator events."""
    return types.SimpleNamespace(
        autograd=types.SimpleNamespace(
            DeviceType=types.SimpleNamespace(CUDA=torch.autograd.DeviceType.CPU)),
        cuda=types.SimpleNamespace(synchronize=lambda: None))


def run(smoke, issued, tries=3):
    """Profile a body that counts 2 launches a take and issues
    ``issued[take]`` multiplications; returns the takes, the launches the
    returned trace lacks, and the resets."""
    count = {"launches": 0, "take": 0, "resets": 0}
    x = torch.ones(4)

    def body():
        for _ in range(issued[min(count["take"], len(issued) - 1)]):
            torch.mul(x, 2.0)
        count["launches"] += 2
        count["take"] += 1

    def reset():
        count["resets"] += 1
    _, takes, lost = smoke.whole_profile(
        cpu_as_device(), body, [torch.profiler.ProfilerActivity.CPU],
        [(lambda: count["launches"], {"aten::mul"})], reset=reset, tries=tries)
    return takes, lost, count["resets"]


@pytest.mark.parametrize("issued,takes,lost", [([2], 1, 0), ([3], 1, 0), ([1], 1, 1),
                                               ([0, 2], 2, 0), ([0, 0, 1], 3, 1)])
def test_whole_profile_retakes_a_trace_without_a_kind(smoke, issued, takes, lost):
    assert run(smoke, issued) == (takes, lost, takes - 1)


def test_whole_profile_stops_after_its_tries(smoke):
    assert run(smoke, [0], tries=3) == (3, 2, 2)


def test_whole_profile_retakes_a_trace_without_device_events(smoke):
    count = {"take": 0}

    def body():
        if count["take"]:
            torch.mul(torch.ones(2), 2.0)
        count["take"] += 1
    _, takes, lost = smoke.whole_profile(cpu_as_device(), body,
                                         [torch.profiler.ProfilerActivity.CPU], [])
    assert (takes, lost) == (2, 0)


@pytest.mark.parametrize("name,want", [
    ("void (anonymous namespace)::paged_verify_kernel<__nv_bfloat16, 128>(Params)",
     "paged_verify_kernel"),
    ("void (anonymous namespace)::verify_kernel_combine<float, 64>(Params)",
     "verify_kernel_combine"),
    ("void ssd_scan<__nv_bfloat16, 64>(Params)", "ssd_scan"),
    ("void (anonymous namespace)::rmsnorm_fwd_kernel<float, 4>(float const*)",
     "rmsnorm_fwd_kernel"),
    ("nvjet_tst_64x8_64x16_4x1_v_bz_NNT", "nvjet_tst_64x8_64x16_4x1_v_bz_NNT"),
])
def test_kernel_name_strips_namespace_and_templates(smoke, name, want):
    assert smoke.kernel_name(name) == want


def test_serving_and_training_kinds_name_every_kernel_of_their_counters(smoke):
    """Each kind names only kernels that the sources define."""
    csrc = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc")
    text = "".join(open(os.path.join(csrc, f)).read() for f in sorted(os.listdir(csrc))
                   if f.endswith(".cu"))
    m = types.SimpleNamespace(K4=None, K5=None, K6=None)
    for _, names in smoke.serving_kinds() + smoke.train_kinds(m):
        for n in names:
            assert f" {n}(" in text or f") {n}(" in text, n
