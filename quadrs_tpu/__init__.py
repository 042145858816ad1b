"""quadrs_tpu — an IQ signal-processing framework in JAX for accelerators.

A ground-up rebuild of the capabilities of the Rust SDR tool ``quadrs``
(reference: FauxFaux/quadrs) that runs on a GPU: raw IQ captures
(cf32 / cs8 / cu8 / cs16) are decoded on device, pushed through a lazily
composed stream graph of DSP stages (NCO frequency shift, Blackman
windowed-sinc FIR low-pass with decimation, strided short-time FFTs) that
jit-compiles into batched XLA programs, and rendered as terminal
spectrograms, symbol streams, written ``.cf32`` captures, or waterfall
images.

Architecture notes
------------------
The reference models DSP as a lazy, pull-based ``Samples`` trait
(reference ``src/samples.rs:11-28``) where each stage computes inside
``read_at`` on demand.  Here the same lazy composition exists at graph
*build* time, but execution is batched: a sink gathers a batch of window
offsets, the *host* resolves all offset-dependent exact-integer planning
(file spans, valid counts, NCO phase fractions) with Python/numpy integer
arithmetic, and the *device* runs one jit-compiled program over the whole
batch — decode, mix, FIR, FFT all fused by XLA.
"""

from quadrs_tpu.formats import FileFormat, FileDetails
from quadrs_tpu.stream import (
    Agc,
    DcBlock,
    IqCorrect,
    LowPass,
    Resample,
    Shift,
    Stream,
)
from quadrs_tpu.sources import (
    LivePipeStream,
    PipeSource,
    SampleSource,
    ToneGen,
    open_capture,
)
from quadrs_tpu.pipeline import Operation, exec_operation, run_pipeline
from quadrs_tpu.stream_runner import RunStats, ScanResult, StreamRunner, WaterfallRunner

__version__ = "0.1.0"

__all__ = [
    "FileFormat",
    "FileDetails",
    "Stream",
    "Shift",
    "LowPass",
    "Resample",
    "DcBlock",
    "Agc",
    "IqCorrect",
    "LivePipeStream",
    "PipeSource",
    "SampleSource",
    "ToneGen",
    "open_capture",
    "Operation",
    "exec_operation",
    "run_pipeline",
    "StreamRunner",
    "WaterfallRunner",
    "RunStats",
    "ScanResult",
]
