"""Device kernels (jitted XLA programs) for marex_tpu."""

from . import climatology, detrend, label, morphology, overlap, partition, properties, quantile  # noqa: F401

__all__ = ["climatology", "detrend", "label", "morphology", "overlap", "partition", "properties", "quantile"]
