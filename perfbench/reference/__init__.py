"""The plain reference that decides ``correct``: torch and NumPy only, and
nothing of the program."""
