"""The port's trace script and usage examples on the CPU:
``scripts/capture_trace`` at a tiny shape (its Chrome trace holds the three
sections; no device time is claimed on the CPU), the three examples'
``main`` with ``--device cpu`` (``--tiny`` for ``serve``), and every one of
these entry points refusing to run without CUDA unless given the CPU."""

import functools
import json
import math
import os
import tempfile

import pytest
import torch
import torch.distributed as dist

import _torch_cores  # noqa: F401 (shares the cores among workers)
from sink_attention_tpu_torch.examples import kernels, serve, train
from sink_attention_tpu_torch.scripts import capture_trace
from sink_attention_tpu_torch.scripts import numerical_accuracy

SECTIONS = ("prefill_fwd", "train_fwdbwd", "decode_scan_64")
TINY = dict(batch=1, heads=4, kv_heads=2, head_dim=16, sinks=4, window=64,
            n=256)


def test_capture_trace_holds_the_three_sections(tmp_path):
    out = capture_trace.capture(str(tmp_path), "cpu", **TINY)
    assert out["files"] == [str(tmp_path / "trace.json")]
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert set(SECTIONS) <= names
    assert tuple(out["sections"]) == SECTIONS
    for sec in out["sections"].values():
        assert sec["wall_ms"] > 0
        # the CPU runs the plain versions: no launch, no device time
        assert sec["device_ms"] is None and sec["idle_share"] is None
        assert set(sec["launches"].values()) == {0}
        assert set(sec["trace_launches"]) == set(capture_trace.KERNEL_NAMES)


def test_capture_trace_main_prints_the_files(tmp_path, capsys,
                                             monkeypatch):
    # the command line takes OUTDIR and the device; the headline's shapes
    # are cut to TINY and 2 decode steps through capture's arguments
    monkeypatch.setattr(capture_trace, "capture", functools.partial(
        capture_trace.capture, **TINY, steps=2))
    assert capture_trace.main([str(tmp_path), "--device", "cpu"]) == 0
    text = capsys.readouterr().out
    assert str(tmp_path / "trace.json") in text
    assert "decode_scan_2: wall" in text and "device not measured" in text


def test_capture_trace_default_outdir_follows_tmpdir(tmp_path, monkeypatch):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    assert capture_trace.default_outdir() == os.path.join(str(tmp_path),
                                                          "sink_trace")


def test_kernels_example():
    out = kernels.main(["--device", "cpu"])
    assert out["prefill_err"] <= 2e-2
    assert out["packed_shape"] == (1, 8, 512, 64)
    assert out["decode_shape"] == (1, 8, 1, 64)


@pytest.mark.parametrize("bits", ["16", "8", "4"])
def test_serve_example_tiny(bits):
    out = serve.main(["--device", "cpu", "--tiny", "--tokens", "3",
                      "--bits", bits, "--layers", "2"])
    assert sorted(out) == [0, 1, 2, 3]
    assert all(len(t) == 3 for t in out.values())


def test_train_example_world_of_one():
    losses = train.main(["--device", "cpu"])
    assert len(losses) == 5 and all(map(math.isfinite, losses))
    assert losses[-1] < losses[0]
    assert not dist.is_initialized()  # the group it started is gone


@pytest.mark.parametrize("entry", [kernels.main, serve.main, train.main,
                                   capture_trace.main,
                                   numerical_accuracy.main])
def test_entry_points_refuse_to_run_without_cuda(entry, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    argv = [str(tmp_path)] if entry is capture_trace.main else []
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry(argv)


def test_trace_section_takes_device_events_by_their_launch():
    """A section's device events are those launched (runtime call on the
    host, same correlation id) inside its host range, wherever the device
    clock puts them: here a kernel whose device time falls in the next
    section, and the next section's kernel whose device time falls here."""
    from types import SimpleNamespace as Ev

    from torch.autograd import DeviceType
    from torch.autograd.profiler_util import Interval

    def ev(name, dev, id, t0, t1):
        return Ev(name=name, device_type=dev, id=id,
                  time_range=Interval(t0, t1))

    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    events = [ev("a", cpu, 1, 0, 100), ev("b", cpu, 2, 100, 200),
              ev("cudaLaunchKernel", cpu, 11, 10, 20),
              ev("aten::add", cpu, 12, 30, 40),
              ev("cudaLaunchKernelExC", cpu, 13, 150, 160),
              ev("void fwd_wgmma_kernel<128>", cuda, 11, 120, 150),
              ev("void short_decode_kernel<128>", cuda, 13, 60, 70),
              ev("elementwise_kernel", cuda, 12, 50, 55),  # an aten op's id
              ev("a", cuda, 1, 10, 150)]                   # GPU annotation
    a = capture_trace._section(events, "a", ("a", "b"), 1.0, {})
    b = capture_trace._section(events, "b", ("a", "b"), 1.0, {})
    assert a["trace_launches"]["flash_fwd"] == 1 == a["device_events"]
    assert a["device_ms"] == pytest.approx(0.03)
    assert b["trace_launches"]["decode"] == 1 == b["device_events"]
    assert b["trace_launches"]["flash_fwd"] == 0
