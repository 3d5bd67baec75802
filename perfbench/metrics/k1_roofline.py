"""K1's share of its roofline: the least time the card could take for the
q passes the batch driver made (one a driver iteration, counted from the
reports, not from any kernel's launches; 4 b m n operations at the bf16
peak, m n 2 + 2 b n 4 bytes), over the device time of the kernels named
here in the traced calls."""

from perfbench.metrics._yardstick import (bound_seconds, iterations_run,
                                          q_pass_work)

# K1 is a D -> bf16 round and two passes of the bf16 ring GEMM
KERNELS = ("round_to_bf16_kernel", "gemm_bf16_async_kernel")


def read(run):
    t = run.traced
    if t is None:
        return None
    busy = sum(e - s for name, s, e in t.device
               if any(k in name for k in KERNELS))
    if busy <= 0:
        return None
    flops, nbytes = q_pass_work(run.traffic["batch"], run.config["m"],
                                run.config["n"])
    bound = iterations_run(t.calls) * bound_seconds(flops, nbytes, "bf16")
    return 100 * bound / busy
