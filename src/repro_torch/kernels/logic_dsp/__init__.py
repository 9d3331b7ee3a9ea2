from repro_torch.kernels.logic_dsp.ops import (forward_words, logic_forward,
                                               logic_infer_bits,
                                               mega_forward_words,
                                               mega_infer_bits, pack_bits,
                                               program_arrays, unpack_bits)
from repro_torch.kernels.logic_dsp.ref import (logic_forward_ref,
                                               mega_forward_ref)

__all__ = ["forward_words", "logic_forward", "logic_infer_bits",
           "logic_forward_ref", "mega_forward_ref", "mega_forward_words",
           "mega_infer_bits", "pack_bits", "program_arrays", "unpack_bits"]
