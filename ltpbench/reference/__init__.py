"""The plain reference of each configuration and the arithmetic the
benchmark measures with. Nothing here imports the program."""
