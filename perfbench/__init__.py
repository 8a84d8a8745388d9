"""The benchmark of the PyTorch / CUDA port (``repro_torch``) on one H100.

One command runs one cell of ``BENCHMARK.json`` once::

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Everything that belongs to one configuration, traffic mix, kind of cell
or metric sits in a file of its own, found by name:

  configs/<config>.json    the configuration as it is run (its published
                           keys, the run's settings, limits of the check)
  traffic/<mix>.json       the parameters one general generator
                           (``lib/gen.py``) reads
  kinds/<kind>.py          the runner of one kind of cell (``serve``,
                           ``train``, ``rma``)
  metrics/<metric>.py      one metric: its reader, unit, layer and the
                           end-to-end metric it moves
  reference/               the plain references that decide ``correct``
  yardstick/               the frozen H100 peaks and the operation and
                           byte counts every roofline and mfu reckons by
"""
