from repro_torch.data.synthetic import (make_binary_classification,
                                        train_val_split)

__all__ = ["make_binary_classification", "train_val_split"]
