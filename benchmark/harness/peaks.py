"""Published peaks of the cards the benchmark runs on (NVIDIA's data
sheets, dense rates without sparsity, at the full power limit): float32
operations outside the tensor cores and HBM bandwidth."""

from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": dict(fp32_flops=67e12, hbm_bytes=3.35e12),
}


def peaks(kind: str) -> dict:
    if kind not in PEAKS:
        raise KeyError(f"no published peaks for {kind!r}; "
                       f"benchmark/harness/peaks.py has {sorted(PEAKS)}")
    return PEAKS[kind]
