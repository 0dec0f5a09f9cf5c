"""The plain reference of the simulator: exact periodic k-NN, features,
the model, the Euler step, the loss and Adam, in float32 PyTorch. It
imports nothing of the program under test."""
