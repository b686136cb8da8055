from .fer import simulate_frame_error_rate_qary

__all__ = ["simulate_frame_error_rate_qary"]
