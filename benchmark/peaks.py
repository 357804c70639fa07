"""Published peaks of the cards the benchmark knows (NVIDIA's data sheet,
SXM part, dense rates without sparsity, at the full 700 W power limit)."""

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "hbm_bytes_per_s": 3.35e12},
}


def of(kind: str) -> dict | None:
    """The peaks of the card named ``kind``, or None for a card not listed
    (a metric that needs them is then not reported)."""
    return PEAKS.get(kind)
