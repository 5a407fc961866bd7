"""Stage-2 training: configuration, loss, optimiser and the step."""
