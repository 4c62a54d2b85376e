"""The plain reference: CRAFT, the box extraction, the crops and PARSeq in
fp32 PyTorch and NumPy, from the weights files alone. Imports nothing of
the program."""
