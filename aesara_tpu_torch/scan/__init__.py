"""Scan, the symbolic loop (the counterpart of ``aesara_tpu/scan``):
``scan`` and ``until`` build it, ``map``/``reduce``/``foldl``/``foldr``
are its views, and ``scan/rewriting.py`` registers the JAX package's
scan rewrites in optdb.  The loop runs on the card through
``link/torch/scan_dispatch.py``."""

from aesara_tpu_torch.scan.basic import scan, until  # noqa: F401
from aesara_tpu_torch.scan.op import Scan, ScanInfo  # noqa: F401
from aesara_tpu_torch.scan.views import foldl, foldr, map, reduce  # noqa: F401
from aesara_tpu_torch.scan import utils  # noqa: F401
from aesara_tpu_torch.scan.utils import ScanArgs  # noqa: F401
from aesara_tpu_torch.scan import rewriting  # noqa: F401  (registers the scan rewrites)
from aesara_tpu_torch.link.torch import scan_dispatch  # noqa: F401,E402  (registers Scan's lowering)
