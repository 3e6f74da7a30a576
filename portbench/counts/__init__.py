"""Operations and bytes: the model's FLOPs (``model_flops``), each kernel's
name pattern, operations and bytes (``k1``, ``k2``, ``k5``), and the
published peaks they are held to (``peaks``)."""
