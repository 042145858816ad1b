"""Benchmark: sustained throughput of the flagship pipeline on one GPU.

Measures the BASELINE north-star chain — on-device cs8 decode -> NCO
shift -> windowed-sinc FIR (400 taps, decimate 32) -> 64-point strided
STFT — in streaming mode on one card, as one XLA program per chunk.
The capture chunk is resident in device memory (as in a production
pipeline where the double-buffered loader keeps the next chunk staged
while the current one computes); each iteration processes the chunk
under fresh NCO phases so nothing is cached or constant-folded.  Prints
one JSON line that names the device it ran on; refuses to run without a
GPU.
"""

from __future__ import annotations

import json
import os

import jax


def main() -> None:
    from bench_suite import (
        chain_flops_per_sample,
        make_acc_step,
        require_gpu,
        roofline,
    )
    from quadrs_tpu.formats import FileFormat
    from quadrs_tpu.models.receiver import PipelineConfig, PipelineModel
    from quadrs_tpu.utils.compile_cache import enable_compile_cache
    from quadrs_tpu.utils.timing import measure_msps_acc

    require_gpu()
    enable_compile_cache()
    dev = jax.devices()[0]

    cfg = PipelineConfig(
        sample_rate=21_000_000,
        shift_freq=280_000,
        lp_freq=200_000,
        decimate=32,
        taps=400,
        fft_width=64,
        fmt=FileFormat.COMPLEX_INT8,
    )
    model = PipelineModel(cfg)
    chunk = 1 << 22  # the CLI's default 4M-sample chunk
    raw = jax.device_put(model.synth_raw(chunk + cfg.taps))
    step = make_acc_step(model, chunk)(raw)

    tstats: dict = {}
    msps = measure_msps_acc(step, chunk, 4.5, reps=3, stats_out=tstats)
    line = {
        "metric": "cs8 decode+shift+lowpass(dec32,taps400)+stft64 throughput",
        "value": round(msps, 1),
        "unit": "Msamples/sec/chip",
        "device": {
            "platform": dev.platform,
            "kind": dev.device_kind,
            "count": len(jax.devices()),
        },
        **tstats,
    }
    # roofline position: algorithmic GFLOP/s + minimal HBM traffic
    # (BASELINE.json's metric line names "FIR+FFT GFLOP/s")
    line.update(
        roofline(
            msps,
            chain_flops_per_sample(cfg.taps, cfg.decimate, cfg.fft_width),
            cfg.fmt.pair_bytes + 4.0 / cfg.decimate,
        )
    )

    # fold the stretch configs into the same line
    # (QUADRS_BENCH_HEADLINE_ONLY=1 skips them)
    if not os.environ.get("QUADRS_BENCH_HEADLINE_ONLY"):
        try:
            import bench_suite

            line["suite"] = bench_suite.suite()
        except Exception as e:  # the headline must survive a suite failure
            line["suite_error"] = f"{type(e).__name__}: {e}"

    print(json.dumps(line))


if __name__ == "__main__":
    main()
