"""The benchmark of ``llzlab_tpu_torch``, the PyTorch and CUDA port:
``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` (see ``README.md``)."""
