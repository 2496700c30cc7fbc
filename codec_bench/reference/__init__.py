"""Plain NumPy references of the containers the benchmark checks. They
import nothing of the codec under test."""
