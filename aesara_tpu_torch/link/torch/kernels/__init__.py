"""Hand-written Hopper kernels of the port, each with its plain PyTorch
version: K1 ``elemwise`` (Triton), K2/K3 ``attention``, K4 ``softmax`` and
K5-K7 ``sparse`` (CUDA C++), and four with no Pallas counterpart: the
threefry draw ``threefry`` (Triton) and the loop samplers and MRG31k3p
streams of ``random_loops`` (TG, TP, TB, TM; CUDA C++).

Nothing here imports ``triton`` or builds a kernel at import time.  Each
wrapper counts its kernel's launches (``.launches``; a launch into a
stream that is capturing a CUDA graph is recorded into the graph) and
its calls that took the plain version (``.plain_calls``).  A replay of a
captured graph runs the recorded launches again without calling the
wrapper: the linker adds them to ``.replayed``, a tally kept apart from
the launches (``link/torch/linker.py``).
"""


def counted_wrappers() -> tuple:
    """The kernel wrappers that count their launches: K1, K2, K3, K4, K5,
    K6, K7, the threefry draw, TG, TP, TB and TM."""
    from aesara_tpu_torch.link.torch.kernels.attention import flash_attention, flash_attention_grads
    from aesara_tpu_torch.link.torch.kernels.elemwise import fused_elemwise
    from aesara_tpu_torch.link.torch.kernels.random_loops import binomial_draw, gamma_draw, mrg_draw, poisson_draw
    from aesara_tpu_torch.link.torch.kernels.softmax import softmax_rows
    from aesara_tpu_torch.link.torch.kernels.sparse import csr_sddmm, csr_spmm, csr_spmv
    from aesara_tpu_torch.link.torch.kernels.threefry import threefry_draw

    return (fused_elemwise, flash_attention, flash_attention_grads, softmax_rows, csr_spmv, csr_spmm, csr_sddmm,
            threefry_draw, gamma_draw, poisson_draw, binomial_draw, mrg_draw)
