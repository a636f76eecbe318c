"""Reliability primitives of the port.

Only the atomic writers the observability core needs are ported so far
(``checkpoint.atomic_file``, ``journal.atomic_write_json``); the guard, sync
policy, journal, session and fault injection of ``metrics_tpu/reliability/``
come with ROADMAP Queue 1 item 4.
"""
