"""The plain reference of every cell, and the comparisons that decide
`correct`. Imports nothing of the program."""
