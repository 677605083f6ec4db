"""Global settings (persisted in the KV store, editable live over HTTP).

Reference surface: GlobalSettings (clearcam.py:1395-1416) with secret masking
on read (userID/key become booleans) and the model-size id map
(clearcam.py:45).
"""
from __future__ import annotations

MODEL_SIZE_IDS = {1: "t", 2: "s", 3: "m", 4: "c", 5: "e",
                  6: "nano", 7: "small", 8: "medium", 9: "large"}


class GlobalSettings:
    def __init__(self, use_clip=False, use_face=False, model_size="t",
                 model_res=960, userID=None, key=None, use_qwen=False,
                 qwen_size=2):
        self.use_clip = use_clip
        self.use_face = use_face
        self.model_size = model_size
        self.model_res = model_res
        self.userID = userID
        self.key = key
        self.use_qwen = use_qwen
        self.qwen_size = qwen_size

    def masked(self) -> "GlobalSettings":
        """Secrets become presence booleans for API reads (clearcam.py:1406)."""
        return GlobalSettings(
            use_clip=self.use_clip, use_face=self.use_face,
            model_size=self.model_size, model_res=self.model_res,
            userID=self.userID is not None, key=self.key is not None,
            use_qwen=self.use_qwen, qwen_size=self.qwen_size)

    def to_dict(self) -> dict:
        return dict(self.__dict__)

    @staticmethod
    def from_dict(d: dict, current: "GlobalSettings | None" = None) -> "GlobalSettings":
        """POST /edit_settings semantics: userID/key == True keeps the stored
        secret (clearcam.py:1028-1029)."""
        d = dict(d)
        if current is not None:
            if d.get("userID") is True:
                d["userID"] = current.userID
            if d.get("key") is True:
                d["key"] = current.key
        allowed = {"use_clip", "use_face", "model_size", "model_res",
                   "userID", "key", "use_qwen", "qwen_size"}
        return GlobalSettings(**{k: v for k, v in d.items() if k in allowed})
