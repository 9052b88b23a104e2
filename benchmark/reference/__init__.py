"""The plain reference and the inputs made from the seed: no code of the program."""
