"""SPEED's TIG training in PyTorch, with hand-written CUDA kernels for
Hopper: the port of the JAX package ``repro``, which stays the reference.

Entry points run on the card (``device=None`` means ``"cuda"``) unless the
caller asks for the CPU; on the CPU the kernels' plain PyTorch versions
run instead. See ``repro_torch.tig.train.train_single``.
"""
