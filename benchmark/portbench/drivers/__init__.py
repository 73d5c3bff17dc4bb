"""Drivers: the code that drives one entry point of moonshine_tpu_torch
for a traffic mix that names it.  Each provides ``setup``, ``window``,
``trace``, ``release`` and ``check`` over a ``runner.Context``."""
