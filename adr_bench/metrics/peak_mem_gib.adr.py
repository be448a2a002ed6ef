"""Peak device memory of the ADR cell, GiB: per-layer there, since each
refit row count seen for the first time captures a fit, so a faster run
that fits more iterations into its window reads higher."""
from benchkit.readers import peak_mem_gib as read  # noqa: F401
