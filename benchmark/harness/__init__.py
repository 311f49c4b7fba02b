"""The harness: cells, the closed-loop window, tracing and the result line."""
