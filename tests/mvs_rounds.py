"""The MVS host loop's dispatch-ahead rule as a count: how many rounds one
stage enqueues, each one K2 sweep on the card.  Shared by the CPU schedule
test (tests/test_torch_mvs_schedule.py) and the card tests, so it imports
nothing (the card runs without jax)."""


def enqueued_rounds(rounds, total, seeds, cfg, serial=False, backlog_left=0):
    """(rounds enqueued, rounds enqueued and never read) of one fresh MVS
    stage that read ``rounds`` rounds and accepted ``total`` patches from
    ``seeds`` seeds at ``cfg``, by the rule of the host loop
    (``mvs/pipeline.py``, the JAX package's): every chunk of
    ``rounds_per_call`` rounds it read from, whole, plus the next chunk
    where the loop enqueued it ahead of the read that ended the stage.
    That happens only where the stage stopped on a dry round with no
    backlog (not on a budget) and, at that read, no checkpoint was due
    (``serial``), rounds + chunk < max_rounds and total + chunk * cap <
    max_patches, with total then between the seeds and the final total.
    Raises where those bounds cannot decide it."""
    k = max(cfg.rounds_per_call, 1)
    chunks = -(-rounds // k)
    enqueued = chunks * k
    ended_on_budget = rounds >= cfg.max_rounds or total >= cfg.max_patches
    if serial or ended_on_budget or backlog_left:
        return enqueued, enqueued - rounds
    before = (chunks - 1) * k
    room = cfg.max_patches - k * cfg.round_capacity
    if before + k >= cfg.max_rounds or seeds >= room:
        ahead = 0
    elif total < room:
        ahead = k
    else:
        raise RuntimeError(f"dispatch-ahead undecidable: {seeds} <= total "
                           f"before the last read <= {total}, limit {room}")
    return enqueued + ahead, enqueued + ahead - rounds
