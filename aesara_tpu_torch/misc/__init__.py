"""Small helpers (reference ``aesara_tpu/misc``)."""
