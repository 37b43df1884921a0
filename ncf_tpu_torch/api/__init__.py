from ncf_tpu_torch.api.app import RecommendationAPI, make_handler, serve

__all__ = ["RecommendationAPI", "make_handler", "serve"]
