from repro_torch.kernels.xnor_gemm.ops import pack_pm1, xnor_gemm
from repro_torch.kernels.xnor_gemm.ref import (xnor_and_popc_ref,
                                               xnor_gemm_ref, xnor_packed_ref)

__all__ = ["xnor_gemm", "pack_pm1", "xnor_and_popc_ref", "xnor_gemm_ref",
           "xnor_packed_ref"]
