"""A copy-on-write fork forced at admission, shared by
``tests/test_torch_mla.py`` and ``chip_smoke.py`` (which reads this file
on the card, so it imports nothing).

The engine's own flow never writes into a shared prefix block: a slot's
writes start past its shared span.  ``forced_forks`` widens the write
span of every admission that maps shared blocks to those blocks, so
each is copied (``network.copy_paged_blocks``) before the slot's first
chunk reads it; the tokens must not move.
"""


def forced_forks(eng):
    """``eng`` (a paged ``ContinuousEngine``) with its pool's ``admit``
    forking the shared blocks of each admission it maps."""
    admit = eng.pool.admit

    def fork_admit(slot, prompt, n):
        plan = admit(slot, prompt, n)
        if plan is not None and plan.shared_tokens:
            eng.pool.ensure_writable(slot, 0, plan.shared_tokens - 1)
        return plan
    eng.pool.admit = fork_admit
    return eng
