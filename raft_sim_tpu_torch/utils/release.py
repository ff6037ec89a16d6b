"""The release mark of a standing loop's chunk step.

The JAX package donates a chunk loop's carry to the next chunk
(`donate_argnums`): the buffers a chunk reads are recycled for the ones it
writes, and a host reference to the old carry is a use-after-donate. The
port's ticks are out of place, so it donates nothing; instead each chunk
loop hands its carry to the chunk step and keeps no reference to it, which
frees each tick's input once the next exists. `@releases("state")` marks
such a step: it takes over the carry passed as `state`, and its caller must
not read that carry after the call. The mark changes nothing at run time;
the analyzer's release registry (analysis/policy.py) lists every marked step,
its race pass checks the callers, and its sanitizer (`run --sanitize`)
poisons the released carry once each chunk is done.
"""

from __future__ import annotations


def releases(param: str):
    """Mark a chunk step as taking over the carry its `param` argument holds."""

    def mark(fn):
        fn.__released_param__ = param
        return fn

    return mark
