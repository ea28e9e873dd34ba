"""The plain reference that decides whether a run is correct. Imports
nothing of the measured package."""
