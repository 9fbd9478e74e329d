"""Tracing / profiling utilities.

Replaces the reference's RAII wall-clock scopes (Timer/GuardedTimer,
src/gmm/src/timer.hh:12-52, printed at verbosity>=2 around every EM phase)
and ad-hoc time.time() prints with:

  * phase_timer — a context manager that blocks on device results so the
    measured interval is real device time, and records into a structured
    registry (jsonl-able, SURVEY.md section 5 "structured metrics");
  * trace — a wrapper around jax.profiler for on-demand XLA traces;
  * roofline — arithmetic-intensity bookkeeping for the named hot kernels
    (STFT/DFT, mel projection, GMM log-posterior) against the published
    peaks of the device, looked up by its device_kind.
"""

from __future__ import annotations

import contextlib
import json
import time

import jax

__all__ = ["phase_timer", "metrics", "dump_metrics", "trace", "roofline"]

metrics: list[dict] = []


@contextlib.contextmanager
def phase_timer(name: str, sync=None, **labels):
    """Time a phase; `sync` (a pytree of device arrays) is blocked on before
    stopping the clock so async dispatch does not fake speed."""
    t0 = time.perf_counter()
    holder = {}
    try:
        yield holder
    finally:
        target = holder.get("sync", sync)
        if target is not None:
            jax.block_until_ready(target)
        dt = time.perf_counter() - t0
        metrics.append({"phase": name, "seconds": dt, **labels})


def record_metric(name: str, **labels):
    """Append one structured metric row without timing anything."""
    metrics.append({"phase": name, **labels})


def dump_metrics(path: str):
    import os
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for m in metrics:
            f.write(json.dumps(m) + "\n")


@contextlib.contextmanager
def trace(logdir: str):
    """jax.profiler trace scope; view with tensorboard/xprof."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


# Published dense peaks per device, keyed by jax Device.device_kind.
# Source: NVIDIA H100 Tensor Core GPU data sheet, SXM5 column, dense rates
# (no sparsity) at the 700 W board limit. A card set to a lower power
# limit cannot hold these rates; report the limit beside any share of them.
DEVICE_PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_tflops": 989.0, "tf32_tflops": 495.0, "f32_tflops": 67.0,
        "hbm_gbps": 3350.0},
}


def device_peaks(device_kind: str) -> dict:
    """Peaks of one device; an unknown device is an error, not a default."""
    try:
        return DEVICE_PEAKS[device_kind]
    except KeyError:
        raise ValueError(
            f"no published peaks for device_kind {device_kind!r}; add its "
            "data-sheet row to profiling.DEVICE_PEAKS") from None


def matmul_peak_tflops(device_kind: str, operand_dtype: str = "f32",
                       precision: str = "default") -> float:
    """Peak matmul TFLOP/s for the precision actually in effect.

    bf16 operands run on the tensor cores at the bf16 rate. float32
    operands at XLA's DEFAULT (and HIGH) precision run as TF32 on the
    tensor cores; HIGHEST computes full float32 products on the CUDA
    cores, at the float32 rate."""
    peaks = device_peaks(device_kind)
    if operand_dtype in ("bf16", "bfloat16"):
        return peaks["bf16_tflops"]
    if operand_dtype in ("f32", "float32"):
        key = {"default": "tf32_tflops", "high": "tf32_tflops",
               "highest": "f32_tflops"}[precision]
        return peaks[key]
    raise ValueError(f"unknown operand dtype {operand_dtype}")


def roofline(flops: float, bytes_moved: float, seconds: float,
             device_kind: str, dtype: str = "f32",
             precision: str = "default") -> dict:
    """Achieved fraction of the compute/bandwidth roofline for one kernel.

    `dtype` is the matmul operand dtype and `precision` the matmul
    precision in effect; together they select the peak (see
    matmul_peak_tflops). Raises if the computed fraction exceeds 1 —
    that always means the peak or the flop count is misapplied.
    """
    peak_flops = matmul_peak_tflops(device_kind, dtype, precision) * 1e12
    peak_bw = device_peaks(device_kind)["hbm_gbps"] * 1e9
    intensity = flops / max(bytes_moved, 1.0)
    ridge = peak_flops / peak_bw
    bound = "compute" if intensity >= ridge else "memory"
    limit = peak_flops if bound == "compute" else peak_bw * intensity
    achieved = flops / seconds
    fraction = achieved / limit
    if fraction > 1.0:
        raise ValueError(
            f"impossible fraction_of_roofline {fraction:.3f} (> 1): "
            f"flops={flops:.3g}, bytes={bytes_moved:.3g}, t={seconds:.3g}s, "
            f"peak={peak_flops/1e12:.0f} TF ({dtype}/{precision}) — "
            "the cost model or the peak selection is wrong")
    return {
        "achieved_tflops": achieved / 1e12,
        "intensity_flops_per_byte": intensity,
        "bound": bound,
        "fraction_of_roofline": fraction,
        "peak_tflops": peak_flops / 1e12,
        "device_kind": device_kind,
        "dtype": dtype,
        "precision": precision,
    }
