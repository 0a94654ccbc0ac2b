"""Kernels: kernel 1 (``csrc/paged_attention.cu``) against its roofline in
the profiled sub-window. Each launch (one a layer of every eager step and
burst iteration) is allowed the larger of its operations over the f32
peak and its bytes over the memory peak (``counting.attention_launch``:
the live rows' K/V read once as pooled, q and the output); their sum is
divided by the device time torch.profiler gives the kernel's CUDA
kernels, its combine pass included."""

from bench.harness import counting, window_math

NAMES = ("paged_attention_kernel", "paged_attention_combine")


def read(run):
    tr = run.window.trace
    if tr is None or not run.peaks:
        return None
    spent = sum(v for k, v in tr["by_name"].items()
                if any(n in k for n in NAMES))
    if spent <= 0:
        return None
    least = 0.0
    for s in run.window.prof_steps:
        for starts, valid, _ in window_math.rows(s):
            ops, nbytes = counting.attention_launch(run.hf, starts, valid,
                                                    run.pool_bytes)
            least += counting.least_seconds(ops, nbytes,
                                            run.peaks["f32_flops"],
                                            run.peaks["hbm_bytes"])
    return 100.0 * least * run.n_layers / spent
