import os
import sys

# the benchmark imports itself as the package ``benchmark`` from the root
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
