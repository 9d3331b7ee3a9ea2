"""The port's model code: the dense transformer, its layers and
attention, and the logic-FFN swap."""
