"""Card-only checks: the streaming chain and the waterfall bank at the
sizes ``chip_smoke.py`` runs, under JAX's default matmul precision,
against float64 (a matmul that ran as TF32 fails them).  They skip off
the card; run them there with ``python -m pytest -m gpu tests/``."""

import pytest

from quadrs_tpu.selfcheck import check_stream_precision, check_waterfall_precision

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("taps", [400, 4000])
def test_stream_chain_is_f32_exact_on_the_card(taps):
    check_stream_precision(4_000_000, taps=taps)


def test_waterfall_bank_is_f32_exact_on_the_card():
    check_waterfall_precision(64, 1 << 16)
