"""The port's kernels: CUDA C++ for Hopper (``csrc/``), each behind a
wrapper module that falls back to its plain PyTorch version on the CPU."""


def kernels():
    """Every kernel of the package (a ``CudaKernel`` each, with its
    ``launches`` count)."""
    from tpu_ctc_torch.ops import beam_cuda, birnn_cuda, ctc_cuda
    return (birnn_cuda.KERNEL, birnn_cuda.BWD_KERNEL, birnn_cuda.WIDE_KERNEL,
            birnn_cuda.WIDE_BWD_KERNEL, ctc_cuda.ALPHA, ctc_cuda.BETA,
            beam_cuda.KERNEL, beam_cuda.WIDE_KERNEL, beam_cuda.RECONSTRUCT)
