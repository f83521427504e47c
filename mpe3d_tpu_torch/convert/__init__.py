"""The reference's torch model files: import, export, and a replica of its
GAT for weight-level checks."""
