"""The PyTorch linker: per-op lowerings (``dispatch``), the linker
(``linker``) and the hand-written kernels (``kernels``)."""
