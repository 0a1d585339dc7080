"""The benchmark's harness: cells and metrics found by name, the scene,
the pass, the window, the trace and the comparison that decides
``correct``.  Imports neither ``jax`` nor ``sfm_tpu``; of the program it
takes only the system under test, its stage timers, its launch counters
and its kernel names.
"""
