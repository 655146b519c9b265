"""The port's kernels: CUDA C++ for Hopper (``csrc/``), each behind a
wrapper module that falls back to its plain PyTorch version on the CPU."""


def kernels():
    """Every kernel of the package (a ``CudaKernel`` each, with its
    ``launches`` count; the recurrence's one a row and sweep of
    ``birnn_cuda.INSTANCES``), then the mesh step's collectives
    (``parallel.mesh.Collective``, each with its ``name`` and the number
    of times it was called as ``launches``): ``nccl_grad_sum``, each flat
    all-reduce of the gradients, and ``nccl_loss_sum``, each all-reduce of
    the loss's sums.  A one-rank step calls neither."""
    from tpu_ctc_torch.ops import beam_cuda, birnn_cuda, ctc_cuda
    from tpu_ctc_torch.parallel import mesh
    return (*birnn_cuda.COUNTERS.values(), ctc_cuda.ALPHA, ctc_cuda.BETA,
            beam_cuda.KERNEL, beam_cuda.WIDE_KERNEL, beam_cuda.RECONSTRUCT,
            mesh.GRAD_SUM, mesh.LOSS_SUM)
