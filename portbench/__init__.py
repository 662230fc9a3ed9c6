"""The benchmark of the PyTorch and CUDA port (``peritext_tpu_torch``).

Run one cell: ``python3 -m portbench.run --workload <name> --seed <n>
--seconds <s> --trace <0|1>`` from the root of a checkout.  Cells,
configurations, traffic mixes and metrics are named in ``BENCHMARK.json``;
each has a file of its own here (``configs/``, ``traffic/``,
``metrics/``), found by that name.  ``reference/`` holds the plain Peritext
replay that decides ``correct`` and ``gen/`` the change generators; neither
imports anything of the port.
"""
