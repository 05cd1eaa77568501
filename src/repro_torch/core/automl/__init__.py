"""AutoML-lite (paper §3.3): the regressor pool and the search, copied from
``repro.core.automl``."""
