"""The device operations of each kernel of the port, by the name the
profiler gives them (``trace.short_name``), as regular expressions."""

B1 = r"(mma|f32)_(sweep|wide)_kernel<false"      # forward recurrence
B2 = r"(mma|f32)_(sweep|wide)_kernel<true"       # delta sweep
B3 = r"ctc_alpha_kernel"
B4 = r"ctc_beta_kernel"
BEAM = r"^beam_kernel<"                           # B5 (K <= 128) and B6
WALK = r"reconstruct_kernel"
# cuBLAS's and CUTLASS's matrix products and their split-K reductions:
# the dense layers (forward, dx, dw) and the recurrence's dW products
GEMM = r"gemm|nvjet|cutlass|xmma|splitKreduce"
NCCL = r"(?i)nccl"


def device_s(rec: dict, pattern: str):
    """Device seconds of the traced window's operations matching
    ``pattern``; None where the run was not traced or none ran."""
    import re
    trace = rec.get("trace")
    if not trace:
        return None
    s = sum(v[1] for k, v in trace["ops"].items() if re.search(pattern, k))
    return s if s > 0 else None
