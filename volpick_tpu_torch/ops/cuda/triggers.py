"""Trigger extraction and trigger scan: the CUDA kernels
``csrc/trigger_extract.cu`` and ``csrc/trigger_scan.cu`` and their plain
PyTorch twins.

``trigger_extract`` ports
``volpick_tpu/ops/pallas/triggers.py::trigger_extract_pallas`` (scan and pick
emission in one kernel); its twin is the ``"shift"`` scan path of
``volpick_tpu/ops/triggers.py::extract_triggers_batched``. Both return
``(peak_idx, peak_val, valid, onset, offset)``, each (B, K), and must agree
exactly. The kernel splits a row as ``trigger_scan`` does and gives each pick
its slot from counts that every piece takes alone;
``trigger_extract_pieces`` is that counting in plain PyTorch, a test
instrument. ``trigger_extract_blocked`` is the ``"blocked"`` scan path of the same
function, in plain PyTorch on any device: scan inside blocks, scan of the
block summaries, one combine with the exclusive prefix. That is the two-level
structure of the ``trigger_scan`` kernel (a piece a warp, piece summaries, the
carry from the left), so it holds that algebra to the flat scan where the
kernel cannot run.

``trigger_scan`` ports ``trigger_scan_pallas_raw`` of the same module: the
scanned state ``(onset, max, argmax)`` at every position, each (B, W), with
no emission; ``emit_picks`` is the plain PyTorch emission that follows it
(``volpick_tpu/ops/triggers.py:328-351``). Kernel and twin agree exactly at
every position. The kernel splits a row into pieces of ``scan_plan(B, W)``
samples, one warp a piece, and a warp walks its piece in steps of ``SCAN_STEP``.

Each wrapper takes the twin for a CPU tensor and the kernel for a CUDA
tensor; there is no other route.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from volpick_tpu_torch.ops.cuda import _build, refuse_autograd

_I32_MAX = 2**31 - 1
# what trigger_scan reports as the max of a stretch outside any run: the
# finite stand-in for -inf of volpick_tpu/ops/pallas/triggers.py
SCAN_NEG = -3.4e38

# the trigger_scan kernel: samples a warp scans at a time (32 lanes x 4), and
# the number of warps the split of the rows aims at (16 an SM of an H100's 132:
# at (24, 120000) no slower than 32 an SM, and 3000 rows of 6000 stay whole,
# which a second piece a row would slow by a fifth)
SCAN_STEP = 128
SCAN_TARGET_WARPS = 2112

# the trigger_extract kernel: rows of several pieces go in one cooperative
# launch where the card holds every CTA of it at once (with scan_plan's split
# an H100 always does), else in two plain launches; False takes the two
# launches everywhere, which is how the tests and scripts/k1_k4_designs.py
# reach them on an H100
EXTRACT_COOPERATIVE = True

launches = 0  # calls of trigger_extract that went to its kernel (one or two launches each)
scan_launches = 0  # calls of trigger_scan that went to its kernel (one or two launches each)

Picks = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]
Scan = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _combine(a, c):
    """Segmented-scan monoid of ``volpick_tpu/ops/triggers.py::_combine``:
    state (flag, onset, max, argmax); ``a`` covers the earlier samples."""
    af, a_on, a_m, a_am = a
    cf, c_on, c_m, c_am = c
    use_c = c_m > a_m  # strict: the first occurrence of the max wins
    m = torch.where(use_c, c_m, a_m)
    am = torch.where(use_c, c_am, a_am)
    on = torch.minimum(a_on, c_on)
    return (
        af | cf,
        torch.where(cf, c_on, on),
        torch.where(cf, c_m, m),
        torch.where(cf, c_am, am),
    )


def _identity(state, shape, neg: float):
    """The identity state in arrays of `shape`, typed like `state`."""
    return tuple(torch.full(shape, fill, dtype=arr.dtype, device=arr.device)
                 for arr, fill in zip(state, (False, _I32_MAX, neg, 0)))


def _shift_right(state, d: int, neg: float):
    """Shift each state array right by d along its last axis, filling with
    the identity."""
    out = []
    for arr, fill in zip(state, _identity(state, state[0].shape, neg)):
        fill[..., d:] = arr[..., : arr.shape[-1] - d]
        out.append(fill)
    return tuple(out)


def _scan(state, neg: float):
    """Hillis-Steele inclusive scan along the last axis: log2(W) shift+combine
    passes. Position 0 takes the identity on its left in the first pass, so a
    stretch before the first run ends with argmax 0, as a fold from the
    identity does."""
    w = state[0].shape[-1]
    d = 1
    while d < w:
        state = _combine(_shift_right(state, d, neg), state)
        d *= 2
    return state


def _scan_blocked(state, neg: float, block: int):
    """Two-level scan of ``volpick_tpu/ops/triggers.py::_scan_blocked``: (B, W)
    is cut into (B, Nb, block), scanned inside the blocks, the blocks' last
    states are scanned over Nb, and each block is combined with the state
    before it (the identity before block 0). Equal to ``_scan`` at every
    position for every block length: the monoid is exactly associative."""
    b, w = state[0].shape
    nb = -(-w // block)
    if nb * block != w:
        state = tuple(torch.cat([arr, pad], dim=1)
                      for arr, pad in zip(state, _identity(state, (b, nb * block - w), neg)))
    intra = _scan(tuple(arr.reshape(b, nb, block) for arr in state), neg)
    summaries = _scan(tuple(arr[..., -1] for arr in intra), neg)
    before = tuple(arr[..., None] for arr in _shift_right(summaries, 1, neg))
    return tuple(arr.reshape(b, nb * block)[:, :w] for arr in _combine(before, intra))


def _scan_assoc(state):
    """Inclusive scan along the last axis by the recursion that
    ``jax.lax.associative_scan`` uses: combine neighbouring pairs (up-sweep),
    scan the pair sums, and give every even position the scan of the pairs
    before it combined with itself (down-sweep). Equal to ``_scan`` at every
    position: the monoid is exactly associative."""
    w = state[0].shape[-1]
    if w < 2:
        return state
    even = tuple(arr[..., 0 : w - 1 : 2] for arr in state)
    odd = tuple(arr[..., 1::2] for arr in state)
    odd_scanned = _scan_assoc(_combine(even, odd))  # positions 1, 3, 5, ...
    later_even = tuple(arr[..., 2::2] for arr in state)  # positions 2, 4, ...
    n_later = later_even[0].shape[-1]
    even_scanned = _combine(tuple(arr[..., :n_later] for arr in odd_scanned), later_even)
    out = []
    for arr, o, e in zip(state, odd_scanned, even_scanned):
        full = torch.empty_like(arr)
        full[..., 0] = arr[..., 0]
        full[..., 1::2] = o
        full[..., 2::2] = e
        out.append(full)
    return tuple(out)


def _run_ends(prob: torch.Tensor, t2: torch.Tensor) -> torch.Tensor:
    """(B, W) bool: the last sample of every > t2 run (a run touching the
    row end ends at W - 1)."""
    above2 = prob > t2[:, None]
    next2 = torch.zeros_like(above2)
    next2[:, :-1] = above2[:, 1:]
    return above2 & ~next2


def _scan_states(
    prob: torch.Tensor, t1: torch.Tensor, t2: torch.Tensor, neg: float, block: int = 0,
    pairwise: bool = False,
) -> Scan:
    """Segmented scan in plain PyTorch: (onset, max, argmax) at every
    position; flat for ``block`` 0, two-level in blocks of that length
    otherwise, and by ``_scan_assoc`` where ``pairwise``."""
    b, w = prob.shape
    above2 = prob > t2[:, None]
    above1 = prob > t1[:, None]
    prev2 = torch.zeros_like(above2)
    prev2[:, 1:] = above2[:, :-1]
    pos = torch.arange(w, dtype=torch.int32, device=prob.device).expand(b, w)
    state = (
        above2 & ~prev2,  # run start
        torch.where(above1 & above2, pos, torch.full_like(pos, _I32_MAX)),
        torch.where(above2, prob, torch.full_like(prob, neg)),
        pos,
    )
    if pairwise:
        scanned = _scan_assoc(state)
    else:
        scanned = _scan_blocked(state, neg, block) if block else _scan(state, neg)
    _, onset, run_max, run_argmax = scanned
    return onset, run_max, run_argmax


def emit_picks(
    prob: torch.Tensor, t2: torch.Tensor, scan: Scan, max_picks: int
) -> Picks:
    """Picks from a scanned state, in plain PyTorch on any device: read at the
    run ends whose run crossed t1, the earliest ``max_picks`` per row in time
    order; unused slots hold idx/onset/offset -1 and value 0."""
    onset, run_max, run_argmax = scan
    b, w = prob.shape
    pos = torch.arange(w, dtype=torch.int32, device=prob.device).expand(b, w)
    emit = _run_ends(prob, t2) & (onset < _I32_MAX)
    # the k smallest emitting positions; non-emitting positions rank last
    order = torch.where(emit, pos, torch.full_like(pos, w))
    if max_picks > w:
        order = torch.cat([order, order.new_full((b, max_picks - w), w)], dim=1)
    top = torch.topk(order, max_picks, dim=1, largest=False, sorted=True).values
    valid = top < w
    safe = torch.where(valid, top, torch.zeros_like(top)).long()
    take = lambda a: torch.gather(a, 1, safe)
    neg1 = torch.full_like(top, -1)
    peak_idx = torch.where(valid, take(run_argmax), neg1)
    peak_val = torch.where(valid, take(run_max), torch.zeros_like(prob[:, :1]))
    on_idx = torch.where(valid, take(onset), neg1)
    off_idx = torch.where(valid, top, neg1)  # the emission position is the run end
    return peak_idx, peak_val, valid, on_idx, off_idx


def trigger_extract_reference(
    prob: torch.Tensor, t1: torch.Tensor, t2: torch.Tensor, max_picks: int
) -> Picks:
    """Plain PyTorch twin of the kernel, on any device.

    prob (B, W) float32, t1/t2 (B,) float32 per-row thresholds. A segmented
    scan gives each sample its run's onset, max and argmax; picks are read at
    the run ends that crossed t1, and the earliest ``max_picks`` per row are
    kept in time order."""
    return emit_picks(prob, t2, _scan_states(prob, t1, t2, float("-inf")), max_picks)


def trigger_extract_blocked(
    prob: torch.Tensor, t1: torch.Tensor, t2: torch.Tensor, max_picks: int, block: int = 2048
) -> Picks:
    """``trigger_extract_reference`` with the two-level scan in blocks of
    ``block`` samples (the JAX package's ``"blocked"`` method and its block
    length), on any device; the same picks."""
    _check(prob, t1, t2, max_picks)
    if block < 1:
        raise ValueError(f"block must be >= 1, got {block}")
    return emit_picks(prob, t2, _scan_states(prob, t1, t2, float("-inf"), block), max_picks)


def trigger_extract_assoc(
    prob: torch.Tensor, t1: torch.Tensor, t2: torch.Tensor, max_picks: int
) -> Picks:
    """``trigger_extract_reference`` with the scan as an up-sweep and a
    down-sweep over pairs (the JAX package's ``"assoc"`` method), on any
    device; the same picks."""
    _check(prob, t1, t2, max_picks)
    return emit_picks(prob, t2, _scan_states(prob, t1, t2, float("-inf"), pairwise=True), max_picks)


def _in_pieces(arr: torch.Tensor, piece: int, fill) -> torch.Tensor:
    """(B, W) → (B, P, piece), the tail of the last piece filled with `fill`."""
    b, w = arr.shape
    n = -(-w // piece)
    if n * piece != w:
        arr = torch.cat([arr, arr.new_full((b, n * piece - w), fill)], dim=1)
    return arr.reshape(b, n, piece)


def trigger_extract_pieces(
    prob: torch.Tensor, t1: torch.Tensor, t2: torch.Tensor, max_picks: int, piece: int
) -> Picks:
    """``trigger_extract_reference`` computed the way the ``trigger_extract``
    kernel computes it, in plain PyTorch on any device: a test instrument that
    holds the kernel's counting to the flat scan where the kernel cannot run.
    No picker path and no ``method=`` name reaches it.

    A row is cut into pieces of ``piece`` samples. Each piece is folded alone,
    from the identity, into a summary and two counts. A run end emits when its
    run has crossed t1. Seen from inside the piece that is decided for every
    run end but one: a run that was open when the piece began and has not
    crossed t1 inside it emits only if it crossed t1 earlier, which the state
    carried into the piece says. So a piece counts ``sure`` (run ends that
    emit whatever the carry) and holds one ``pending`` bit (that one run end).
    The exclusive scan of the summaries gives each piece its carry, the carry
    resolves the bit, the running sum of ``sure + resolved`` gives each piece
    the slot of its first pick, and each piece writes its picks from there,
    those below ``max_picks``. There is no search over the row for the
    earliest picks."""
    _check(prob, t1, t2, max_picks)
    if piece < 1:
        raise ValueError(f"piece must be >= 1, got {piece}")
    b, w = prob.shape
    neg = float("-inf")
    above2 = prob > t2[:, None]
    above1 = prob > t1[:, None]
    prev2 = torch.zeros_like(above2)
    prev2[:, 1:] = above2[:, :-1]
    pos = torch.arange(w, dtype=torch.int32, device=prob.device).expand(b, w)
    elements = (
        above2 & ~prev2,
        torch.where(above1 & above2, pos, torch.full_like(pos, _I32_MAX)),
        torch.where(above2, prob, torch.full_like(prob, neg)),
        pos,
    )
    # 1. every piece alone: the fold from the identity, its counts, its summary
    local = _scan(tuple(_in_pieces(arr, piece, fill)
                        for arr, fill in zip(elements, (False, _I32_MAX, neg, 0))), neg)
    ends = _in_pieces(_run_ends(prob, t2), piece, False)
    crossed = local[1] < _I32_MAX
    sure = (ends & crossed).sum(dim=-1)
    pending = (ends & ~local[0] & ~crossed).any(dim=-1)
    # 2. the state before each piece, which resolves its pending bit
    carry = _shift_right(_scan(tuple(arr[..., -1] for arr in local), neg), 1, neg)
    count = sure + (pending & (carry[1] < _I32_MAX))
    first = torch.cumsum(count, dim=1) - count
    # 3. each piece from its carry: run ends whose run crossed t1, slots from `first`
    _, onset, run_max, run_argmax = _combine(tuple(arr[..., None] for arr in carry), local)
    emit = ends & (onset < _I32_MAX)
    slot = first[..., None] + torch.cumsum(emit, dim=-1) - 1
    keep = emit & (slot < max_picks)
    rows = torch.arange(b, device=prob.device)[:, None, None].expand_as(keep)[keep]
    slots = slot[keep]
    opts = dict(device=prob.device)
    peak_idx = torch.full((b, max_picks), -1, dtype=torch.int32, **opts)
    peak_val = torch.zeros((b, max_picks), dtype=torch.float32, **opts)
    valid = torch.zeros((b, max_picks), dtype=torch.bool, **opts)
    on_idx = torch.full((b, max_picks), -1, dtype=torch.int32, **opts)
    off_idx = torch.full((b, max_picks), -1, dtype=torch.int32, **opts)
    peak_idx[rows, slots] = run_argmax[keep]
    peak_val[rows, slots] = run_max[keep]
    valid[rows, slots] = True
    on_idx[rows, slots] = onset[keep]
    off_idx[rows, slots] = _in_pieces(pos, piece, 0)[keep]
    return peak_idx, peak_val, valid, on_idx, off_idx


def trigger_scan_reference(
    prob: torch.Tensor, t1: torch.Tensor, t2: torch.Tensor, block: int = 0
) -> Scan:
    """Plain PyTorch twin of ``trigger_scan``, on any device; see there for
    what the outputs hold. ``block`` > 0 takes the two-level scan in blocks of
    that length, which gives the same three arrays."""
    return _scan_states(prob, t1, t2, SCAN_NEG, block)


def scan_plan(b: int, w: int) -> Tuple[int, int]:
    """``(piece, n_pieces)``: how the ``trigger_scan`` and ``trigger_extract``
    kernels split a row of W
    samples over warps when there are B rows. The piece is a whole number of
    steps, as few pieces a row as bring the launch to ``SCAN_TARGET_WARPS``
    warps, and one piece a row where the rows alone are that many. A row whose
    start is not 16-byte aligned is walked on a grid shifted by up to 3
    samples, so W not a multiple of 4 plans for W + 3."""
    span = w + (3 if w % 4 else 0)
    steps = -(-span // SCAN_STEP)
    per_row = max(1, min(steps, -(-SCAN_TARGET_WARPS // max(b, 1))))
    piece = -(-steps // per_row) * SCAN_STEP
    return piece, -(-span // piece)


def _check(prob: torch.Tensor, t1: torch.Tensor, t2: torch.Tensor, max_picks: int) -> None:
    if prob.dim() != 2 or prob.shape[1] < 1:
        raise ValueError(f"prob must be (B, W) with W >= 1, got {tuple(prob.shape)}")
    b = prob.shape[0]
    for name, t in (("prob", prob), ("t1", t1), ("t2", t2)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != prob.device:
            raise ValueError(f"{name} is on {t.device}, prob on {prob.device}")
    for name, t in (("t1", t1), ("t2", t2)):
        if tuple(t.shape) != (b,):
            raise ValueError(f"{name} must be ({b},), got {tuple(t.shape)}")
    if max_picks < 1:
        raise ValueError(f"max_picks must be >= 1, got {max_picks}")


_summary_scratch: dict = {}  # (device index, stream) -> (n, 4) int32 tensor


def _summaries(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """Scratch for ``trigger_extract``'s piece summaries, 16 bytes each: kept
    from call to call and grown when a call needs more, one per stream (calls
    on one stream run in order, so the next call's first kernel starts after
    this call's last has read them)."""
    key = (device.index, stream)
    buf = _summary_scratch.get(key)
    if buf is None or buf.shape[0] < n:
        buf = _summary_scratch[key] = torch.empty((n, 4), dtype=torch.int32, device=device)
    return buf


def trigger_extract(
    prob: torch.Tensor, t1: torch.Tensor, t2: torch.Tensor, max_picks: int
) -> Picks:
    """Trigger extraction of (B, W) curves with per-row thresholds t1/t2 (B,).

    A CPU tensor goes to ``trigger_extract_reference``; a CUDA tensor goes to
    the kernel (``scan_plan(B, W)`` pieces a row, one warp each; where a row
    has more than one piece, one cooperative launch, or two plain ones, the
    first for the piece summaries and counts: ``EXTRACT_COOPERATIVE``) or
    raises. ``launches`` counts one a call."""
    global launches
    _check(prob, t1, t2, max_picks)
    if prob.device.type == "cpu":
        return trigger_extract_reference(prob, t1, t2, max_picks)
    if prob.device.type != "cuda":
        raise ValueError(f"trigger_extract runs on cpu or cuda, got {prob.device}")
    refuse_autograd("trigger_extract", prob=prob, t1=t1, t2=t2)
    for name, t in (("prob", prob), ("t1", t1), ("t2", t2)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    b, w = prob.shape
    fn = _build.function(
        "trigger_extract_f32",
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 7,
    )
    opts = dict(device=prob.device)
    peak_idx = torch.empty((b, max_picks), dtype=torch.int32, **opts)
    peak_val = torch.empty((b, max_picks), dtype=torch.float32, **opts)
    valid = torch.empty((b, max_picks), dtype=torch.bool, **opts)
    onset = torch.empty((b, max_picks), dtype=torch.int32, **opts)
    offset = torch.empty((b, max_picks), dtype=torch.int32, **opts)
    if b == 0:
        return peak_idx, peak_val, valid, onset, offset
    piece, n_pieces = scan_plan(b, w)
    stream = torch.cuda.current_stream(prob.device).cuda_stream
    err = fn(
        prob.data_ptr(), t1.data_ptr(), t2.data_ptr(), b, w, max_picks, piece, n_pieces,
        int(EXTRACT_COOPERATIVE), _summaries(prob.device, stream, b * n_pieces).data_ptr(),
        peak_idx.data_ptr(), peak_val.data_ptr(), valid.data_ptr(),
        onset.data_ptr(), offset.data_ptr(), stream,
    )
    if err != 0:
        raise RuntimeError(f"trigger_extract_f32 launch failed: cudaError {err}")
    launches += 1
    return peak_idx, peak_val, valid, onset, offset


def trigger_scan(prob: torch.Tensor, t1: torch.Tensor, t2: torch.Tensor) -> Scan:
    """Segmented trigger scan of (B, W) float32 curves with per-row thresholds
    t1/t2 (B,): ``(onset int32, max float32, argmax int32)``, each (B, W).

    At a position inside a > t2 run: the first > t1 index of the run so far
    (INT32_MAX while it has not crossed t1), the run's max so far and the
    index of its first occurrence. At a position outside any run the three
    keep the state of the last run before it; before the first run of the
    row they hold (INT32_MAX, -3.4e38, 0). Picks are read at run ends, where
    the state covers the whole run (``emit_picks``).

    A CPU tensor goes to ``trigger_scan_reference``; a CUDA tensor goes to
    the kernel (``scan_plan(B, W)`` pieces a row, one warp each; two launches
    where a row has more than one piece, the first for the piece summaries) or
    raises."""
    global scan_launches
    _check(prob, t1, t2, 1)
    if prob.device.type == "cpu":
        return trigger_scan_reference(prob, t1, t2)
    if prob.device.type != "cuda":
        raise ValueError(f"trigger_scan runs on cpu or cuda, got {prob.device}")
    refuse_autograd("trigger_scan", prob=prob, t1=t1, t2=t2)
    for name, t in (("prob", prob), ("t1", t1), ("t2", t2)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    b, w = prob.shape
    onset = torch.empty((b, w), dtype=torch.int32, device=prob.device)
    run_max = torch.empty((b, w), dtype=torch.float32, device=prob.device)
    run_argmax = torch.empty((b, w), dtype=torch.int32, device=prob.device)
    if b == 0:
        return onset, run_max, run_argmax
    piece, n_pieces = scan_plan(b, w)
    # one 16-byte summary for every piece that has a piece on its right
    summaries = torch.empty((b, n_pieces - 1, 4), dtype=torch.int32, device=prob.device)
    fn = _build.function(
        "trigger_scan_f32", [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 5
    )
    err = fn(
        prob.data_ptr(), t1.data_ptr(), t2.data_ptr(), b, w, piece, n_pieces,
        summaries.data_ptr(), onset.data_ptr(), run_max.data_ptr(), run_argmax.data_ptr(),
        torch.cuda.current_stream(prob.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"trigger_scan_f32 launch failed: cudaError {err}")
    scan_launches += 1
    return onset, run_max, run_argmax
