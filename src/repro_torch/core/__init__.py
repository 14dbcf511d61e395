"""Core power-saving library: EEE states and policies, the coupled
per-link FSM replay and the decoupled per-port fast path.

Times are float64 seconds and counters int64, as in the reference; the
decoupled kernels take float32 operands.
"""
