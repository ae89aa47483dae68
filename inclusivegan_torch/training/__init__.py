"""The training slice of the port: losses, Adam, the train state, the four
phases of one iteration and the IMLE retrieval."""
