"""The training slice: losses, state, the train step, checkpoints, the loop."""
