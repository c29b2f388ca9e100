"""The benchmark of fhetpu_torch: ``python3 perfbench/run.py --workload <name>
--seed <n> --seconds <s> --trace <0|1>`` from the root of a checkout."""
