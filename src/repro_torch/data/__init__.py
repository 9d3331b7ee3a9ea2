from repro_torch.data.synthetic import (TokenPipeline,
                                        make_binary_classification,
                                        synthetic_tokens, train_val_split)

__all__ = ["TokenPipeline", "make_binary_classification",
           "synthetic_tokens", "train_val_split"]
