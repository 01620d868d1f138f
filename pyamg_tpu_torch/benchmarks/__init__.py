"""Benchmarks of the port on the card, each runnable as a module:

    python3 -m pyamg_tpu_torch.benchmarks.dia_spmv_bench
"""
