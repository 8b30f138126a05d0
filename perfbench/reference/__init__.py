"""The plain reference: the model, the log-mel and the decode tier's
integer arithmetic in float32 PyTorch, importing nothing of the program."""
