"""Benchmark and analysis harness of fhetpu_torch: the port of
``fhetpu/bench/*`` and of the root ``bench.py`` headline.

* ``timing``: per-iteration time of a chained op (CUDA events on the card);
* ``headline``: the JPEG server op at the four ring degrees, in channel-blocks/s;
* ``noise_validation``: measured invariant-noise budgets against the model
  and against a committed sweep;
* ``benchmark`` and ``decode_sweep``: the reference's grids through the CLIs;
* ``analyze`` and ``results_parser``: the sweep logs' CSV rows.
"""
