"""Benchmark of the PyTorch/CUDA port (``tpu_ctc_torch``) on H100 cards.

One run measures one cell of ``BENCHMARK.json``: a model configuration
(``ctcbench/configs/<name>.json``) under a traffic mix
(``ctcbench/traffic/<name>.json``), driven through the port's own entry
points for ``--seconds`` seconds, then checked against the plain
reference in ``ctcbench/reference/``.  Every metric is read by a file of
its own, ``ctcbench/metrics/<name>.py``; every kernel's operations and
bytes are counted by ``ctcbench/rooflines/<kernel>.py``.  Nothing here
imports JAX or the JAX package.

    python3 -m ctcbench.run --workload <cell> --seed <n>
        --seconds <s> --trace <0|1>
"""
