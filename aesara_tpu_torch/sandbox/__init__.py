"""Sandbox modules of the port (the counterpart of ``aesara_tpu/sandbox``):
the MRG31k3p stream generator (``rng_mrg``) and the uniform-to-multinomial
converters it draws through (``multinomial``)."""
