"""Analysis of the port: the dry run's cost model on traced per-rank graphs
(``hlo``), its roofline terms and the zero-trace floor (``roofline``), and
the dry-run report table (``report``)."""
