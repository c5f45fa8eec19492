"""Reference path ``pipelines``: only ``utils``, the part a pipeline body
imports."""
