"""Device time of the kernels other than the port's hand kernels (cuBLAS
products and plain torch kernels) in the traced calls, in ms per driver
iteration."""

from perfbench.metrics._yardstick import iterations_run, is_copy

# K1 (round and ring GEMM), K2 (gamma scan), K3 (transition), K4 (OMP insert)
HAND = ("round_to_bf16_kernel", "gemm_bf16_async_kernel",
        "gamma_scan_cluster_kernel", "transition_regs_kernel",
        "transition_mem_kernel", "omp_insert_rows_kernel")


def read(run):
    t = run.traced
    if t is None or not t.device:
        return None
    ms = sum(e - s for name, s, e in t.device
             if not is_copy(name) and not any(k in name for k in HAND)) * 1e3
    return ms / iterations_run(t.calls)
