"""Gradient checkpointing for scan (reference ``aesara_tpu/scan/checkpoints.py``):
an outer scan of inner scans, so that the outer loop keeps one state every
``save_every_N`` steps and the gradient recomputes each segment's states
from it.
"""

from __future__ import annotations

from aesara_tpu_torch.scan.basic import scan
from aesara_tpu_torch.tensor.basic import as_tensor_variable


def scan_checkpoints(
    fn,
    sequences=None,
    outputs_info=None,
    non_sequences=None,
    name: str = "checkpointscan_fn",
    n_steps=None,
    save_every_N: int = 10,
    padding: bool = True,
):
    """A scan whose outer loop stores one state every ``save_every_N``
    steps; an inner scan runs each segment, and its gradient recomputes
    the segment's states."""
    if sequences is None:
        sequences = []
    if not isinstance(sequences, (list, tuple)):
        sequences = [sequences]
    sequences = [as_tensor_variable(s) for s in sequences]
    if non_sequences is None:
        non_sequences = []
    if not isinstance(non_sequences, (list, tuple)):
        non_sequences = [non_sequences]
    if isinstance(outputs_info, (list, tuple)):
        if len(outputs_info) != 1:
            raise NotImplementedError(
                "scan_checkpoints supports a single recurrent output"
            )
        out_info = outputs_info[0]
    else:
        out_info = outputs_info

    if n_steps is None:
        if not sequences:
            raise ValueError("scan_checkpoints needs sequences or n_steps")
        n_steps = sequences[0].shape[0]
    n_steps = as_tensor_variable(n_steps)

    import aesara_tpu_torch.tensor.math as tm
    from aesara_tpu_torch.tensor.basic import cast, switch
    from aesara_tpu_torch.tensor.shape import reshape

    N = int(save_every_N)
    n_padded = cast(tm.int_div(n_steps + N - 1, N) * N, "int64")
    if padding and sequences:
        # pad sequences so their length is a multiple of N
        from aesara_tpu_torch.tensor.basic import join, zeros

        def pad(s):
            extra = n_padded - n_steps
            pad_shape = [extra] + [s.shape[i] for i in range(1, s.type.ndim)]
            return join(0, s, zeros(tuple(pad_shape), dtype=s.type.dtype))

        sequences = [pad(s) for s in sequences]

    n_outer = tm.int_div(sequences[0].shape[0], N) if sequences else tm.int_div(
        n_steps + N - 1, N
    )

    # reshape each sequence into (n_outer, N, ...) chunks
    chunked = []
    for s in sequences:
        new_shape = [n_outer, as_tensor_variable(N)] + [
            s.shape[i] for i in range(1, s.type.ndim)
        ]
        chunked.append(reshape(s, new_shape, ndim=s.type.ndim + 1))

    # a mask of the real steps over the padded range: every segment runs N
    # steps, and a padded step keeps the state instead of running fn on
    # the padding
    from aesara_tpu_torch.tensor.basic import arange

    valid = cast(
        tm.lt(arange(n_outer * N, dtype="int64"), cast(n_steps, "int64")),
        "int8",
    )
    valid_chunks = reshape(valid, [n_outer, as_tensor_variable(N)], ndim=2)
    n_seq_user = len(chunked)

    def inner_fn(*args):
        xs = args[:n_seq_user]
        valid_t = args[n_seq_user]
        state = args[n_seq_user + 1]
        nonseqs = args[n_seq_user + 2:]
        res = fn(*xs, state, *nonseqs)
        if isinstance(res, (tuple, list, dict)):
            raise NotImplementedError(
                "scan_checkpoints supports a single recurrent output with "
                "no updates/until in fn"
            )
        return switch(tm.neq(valid_t, 0), res, state)

    def outer_step(*args):
        segs = list(args[: n_seq_user + 1])  # user chunks + valid chunk
        state = args[n_seq_user + 1]
        nonseqs = list(args[n_seq_user + 2:])
        inner_out, inner_updates = scan(
            inner_fn,
            sequences=segs,
            outputs_info=state,
            non_sequences=nonseqs,
            name=name + "_inner",
        )
        if inner_updates:
            raise NotImplementedError(
                "scan_checkpoints does not support shared updates in fn"
            )
        return inner_out[-1]

    outs, updates = scan(
        outer_step,
        sequences=chunked + [valid_chunks],
        outputs_info=out_info,
        non_sequences=list(non_sequences),
        name=name,
    )
    return outs, updates
