"""The loop superstep: one window of consecutive batches, its hits
gathered on the device, with no host sync inside the window -- the
counterpart of the reference's ops/superstep.py (``INT32_BUDGET``,
``max_inner``, ``make_loop_super_step``).

The reference fuses ``inner`` calls of one offset-aware Pallas kernel
into one jitted ``fori_loop``, because each dispatch over its link cost
a round trip and a scan of ``pallas_call`` wedged the TPU compiler; it
compiles one program per power-of-two window size.  Here nothing is
compiled per window: a window is ``ceil(n_valid / batch)`` plain
launches of the mask kernel's step at window offsets ``i * batch``,
with the same base digits and the window's valid lanes, into one set of
hit buffers.  The kernel's atomic append sums the count, and the lanes
it reports are window lanes, so the window decodes like one wide batch.
The launches go out back to back on the current stream: the host takes
about a tenth of a millisecond a launch (PERF.md section 5) and the
card 0.34-3.9 ms for a 2^24 batch of the cores, so the queue stays
ahead of the card.  A CUDA graph would save only host time the card
does not wait for, and would freeze each launch's arguments (its
offset) into the graph.
"""

from __future__ import annotations

#: lanes a window may span: window lane + base digit stays in int32
#: (the kernel's lanes are 32-bit, the plain version's int32)
INT32_BUDGET = (1 << 31) - 256


def max_inner(batch: int, cap: int = 512) -> int:
    """Most batches of one window: INT32_BUDGET and ``cap`` bound it
    (0 when not one batch fits)."""
    return max(0, min(cap, INT32_BUDGET // max(1, batch)))


def loop_super_step(step, batch: int, base_digits, n_valid: int, out):
    """The window [0, n_valid) from ``base_digits`` as ``ceil(n_valid /
    batch)`` launches of an offset-aware step: step(base_digits,
    n_valid, offset=, out=) runs the window lanes [offset, n_valid) of
    one ``batch``-lane batch and appends its hits to ``out`` (fresh hit
    buffers, their capacity the window's).  Each launch is clipped to
    its own batch; a window past INT32_BUDGET is refused by the step's
    own check.  Returns ``out``, the step's result tuple with window
    lanes, still being computed."""
    for offset in range(0, n_valid, batch):
        step(base_digits, min(n_valid, offset + batch), offset=offset,
             out=out)
    return out
