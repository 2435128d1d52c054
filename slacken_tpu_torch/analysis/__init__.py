"""Analysis tools (counterpart of slacken_tpu/analysis/): index migration,
mapping comparison, UniFrac, CAMI reports, report display, and the
synthetic accuracy experiment."""
