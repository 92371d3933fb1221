"""The plain reference: fp32 PyTorch, one module a block family.

``common`` holds the shared pieces (RMSNorm, rotary embedding, the
low-precision rounding of the control), ``dense`` the GQA block with its
gated-SiLU MLP, ``mamba2`` the Mamba-2 block over ``ssd``'s plain chunked
scan, ``lm`` the embedding, the head, the loss and the layer-by-layer
forward and backward, and ``train`` Adam. It imports nothing of the port
and takes no tensor the port has made: the weights and inputs are drawn
again from the seed by ``portbench.weights`` and ``portbench.traffic``.

Every function takes ``lowp``: ``None`` for fp32 (TF32 off), or a
``common.LowP`` that rounds every matrix product's operands to fp8, the
control that must come out as not correct.
"""
