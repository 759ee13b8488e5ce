from .service import LineResult, OcrService, ServiceConfig

__all__ = ["LineResult", "OcrService", "ServiceConfig"]
