"""The benchmark of is3d2_tpu_torch: a harness driven by BENCHMARK.json and
the files it names (``python3 portbench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``)."""
