"""The benchmark of ``caf_cookoff_tpu_torch`` on one NVIDIA H100.

One command runs one cell once, from the root of a checkout:

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``BENCHMARK.json`` at the root names the configurations, the cells and
the metrics.  Everything that belongs to one of them is a file of its
own here, found by that name:

* ``configs/<config>.json``: a deployment's sizes, its source and its
  input recipe's parameters;
* ``workloads/<cell>.json``: a cell's configuration, entry, traffic
  parameters and the limit of each number its check compares;
* ``recipes/<recipe>.py``: a configuration's input model (frozen copies
  of the port's recipes);
* ``entries/<entry>.py``: one public call of the port that a window
  drives, and how its answers are read out;
* ``reference/<entry>.py``: the plain reference an entry's answers are
  judged by (plain ``torch.fft``; it imports nothing of the port);
* ``metrics/<metric>.py``: the reader of one metric.

The yardstick (the window and its clock, the trace reader, the bound
arithmetic, the comparison) is the rest of this folder.  Nothing here
imports JAX or the JAX package.
"""
