"""The training slice of the port: the loop and its schedule, checkpoints,
losses, Adam, the train state, the four phases of one iteration and the IMLE
retrieval."""
