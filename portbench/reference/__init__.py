"""The plain reference: a Peritext replay in plain Python (frozen copies of
the port's oracle and its helpers) and the convergence digest worked out
from the replayed document.  Imports nothing of the port."""
