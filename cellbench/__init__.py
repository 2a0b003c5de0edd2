"""The benchmark of the PyTorch/CUDA port (``repro_torch``) on one H100.

``BENCHMARK.json`` at the repository's root names the cells (a model
configuration under a traffic mix) and the metrics. Everything that
belongs to one configuration, mix or per-layer metric sits in a file of
its own, found by its name:

* ``configs/<config>.json``: the model's sizes as run, their source, what
  was cut and what was assumed;
* ``traffic/<mix>.json``: the parameters that the general generator
  (:mod:`cellbench.generate`) reads, and the driver kind that serves them;
* ``limits/<cell>.json``: the limits that decide ``correct``, with the
  readings each was set from;
* ``metrics/<metric>.py``: the reader of one per-layer metric;
* ``reference/<family>.py``: the plain float32 reference of a family.

``python3 -m cellbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell once and prints its result as the last line
of standard output. Nothing here imports ``jax``, ``jaxlib`` or the JAX
package ``repro``; the reference imports nothing of ``repro_torch``.
"""
