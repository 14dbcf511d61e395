"""Application traces, collective expansions and message-table padding."""
