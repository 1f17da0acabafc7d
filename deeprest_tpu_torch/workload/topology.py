"""The simulated application: DeathStarBench-style social network topology.

Span-tree generators reproduce the wire-level call structure of the
reference application (component/operation names and fan-out shape follow
the reference's hot paths: compose at
social-network-source/src/ComposePostService/ComposePostHandler.h:463-583
and the gateway script nginx-web-server/lua-scripts-k8s/wrk2-api/post/
compose.lua:86-143; reads at HomeTimelineHandler.h:73-102 and
UserTimelineHandler.h; media at media-frontend/lua-scripts-k8s/
upload-media.lua — see SURVEY.md §3.1-3.2).  Probabilistic branches model
what makes real traces vary: optional media/urls/mentions, cache misses
falling through to MongoDB, and mention fan-out.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from deeprest_tpu_torch.data.schema import Span


def _s(component: str, operation: str, *children: Span) -> Span:
    return Span(component=component, operation=operation, children=list(children))


@dataclasses.dataclass(frozen=True)
class AppParams:
    """Branch probabilities of the simulated app (locustfile-normal.py:14-23
    semantics: 20% media, 0-5 mentions; cache-miss rates are deployment
    realism knobs)."""

    p_media: float = 0.20
    p_urls: float = 0.30
    max_mentions: int = 5
    p_cache_miss: float = 0.25
    p_graph_cache_miss: float = 0.15
    mean_read_posts: float = 10.0


class SocialNetworkApp:
    """Generates one span tree per API call."""

    def __init__(self, params: AppParams | None = None):
        self.params = params or AppParams()

    # -- write path ----------------------------------------------------

    def compose_post(self, rng: np.random.Generator) -> list[Span]:
        p = self.params
        traces: list[Span] = []
        if rng.random() < p.p_media:
            traces.append(
                _s("media-frontend", "/upload-media",
                   _s("media-mongodb", "/insert"))
            )

        text_children = []
        if rng.random() < p.p_urls:
            text_children.append(
                _s("url-shorten-service", "/UploadUrls",
                   _s("url-shorten-mongodb", "/insert"),
                   _s("compose-post-service", "/UploadUrls",
                      _s("compose-post-redis", "/hset")))
            )
        n_mentions = int(rng.integers(0, p.max_mentions + 1))
        if n_mentions > 0:
            mention_children = [_s("user-memcached", "/mget")]
            if rng.random() < p.p_cache_miss:
                mention_children.append(_s("user-mongodb", "/find"))
            mention_children.append(
                _s("compose-post-service", "/UploadUserMentions",
                   _s("compose-post-redis", "/hset")))
            text_children.append(
                _s("user-mention-service", "/UploadUserMentions", *mention_children)
            )
        text_children.append(
            _s("compose-post-service", "/UploadText",
               _s("compose-post-redis", "/hset")))

        home_children = [
            _s("social-graph-service", "/GetFollowers",
               _s("social-graph-redis", "/zrange"),
               *([_s("social-graph-mongodb", "/find")]
                 if rng.random() < p.p_graph_cache_miss else [])),
            _s("home-timeline-redis", "/zadd"),
        ]

        traces.append(
            _s("nginx-thrift", "/wrk2-api/post/compose",
               _s("user-service", "/UploadCreatorWithUserId",
                  _s("compose-post-service", "/UploadCreator",
                     _s("compose-post-redis", "/hset"))),
               _s("media-service", "/UploadMedia",
                  _s("compose-post-service", "/UploadMedia",
                     _s("compose-post-redis", "/hset"))),
               _s("text-service", "/UploadText", *text_children),
               _s("unique-id-service", "/UploadUniqueId",
                  _s("compose-post-service", "/UploadUniqueId",
                     _s("compose-post-redis", "/hset"),
                     _s("post-storage-service", "/StorePost",
                        _s("post-storage-mongodb", "/insert")),
                     _s("user-timeline-service", "/WriteUserTimeline",
                        _s("user-timeline-mongodb", "/update"),
                        _s("user-timeline-redis", "/zadd")),
                     _s("write-home-timeline-service", "/Consume",
                        *home_children))))
        )
        return traces

    # -- read paths ----------------------------------------------------

    def _read_posts(self, rng: np.random.Generator) -> list[Span]:
        children = [_s("post-storage-memcached", "/mget")]
        if rng.random() < self.params.p_cache_miss:
            children.append(_s("post-storage-mongodb", "/find"))
        return [_s("post-storage-service", "/ReadPosts", *children)]

    def read_home_timeline(self, rng: np.random.Generator) -> list[Span]:
        return [
            _s("nginx-thrift", "/wrk2-api/home-timeline/read",
               _s("home-timeline-service", "/ReadHomeTimeline",
                  _s("home-timeline-redis", "/zrevrange"),
                  *self._read_posts(rng)))
        ]

    def read_user_timeline(self, rng: np.random.Generator) -> list[Span]:
        children = [_s("user-timeline-redis", "/zrevrange")]
        if rng.random() < self.params.p_cache_miss:
            children.append(_s("user-timeline-mongodb", "/find"))
        return [
            _s("nginx-thrift", "/wrk2-api/user-timeline/read",
               _s("user-timeline-service", "/ReadUserTimeline",
                  *children, *self._read_posts(rng)))
        ]

    # -- account paths -------------------------------------------------

    def register(self, rng: np.random.Generator) -> list[Span]:
        return [
            _s("nginx-thrift", "/wrk2-api/user/register",
               _s("user-service", "/RegisterUser",
                  _s("user-mongodb", "/insert"),
                  _s("social-graph-service", "/InsertUser",
                     _s("social-graph-mongodb", "/insert"))))
        ]

    def follow(self, rng: np.random.Generator) -> list[Span]:
        return [
            _s("nginx-thrift", "/wrk2-api/user/follow",
               _s("social-graph-service", "/Follow",
                  _s("social-graph-mongodb", "/update"),
                  _s("social-graph-redis", "/zadd")))
        ]

    def login(self, rng: np.random.Generator) -> list[Span]:
        children = [_s("user-memcached", "/get")]
        if rng.random() < self.params.p_cache_miss:
            children.append(_s("user-mongodb", "/find"))
        return [
            _s("nginx-thrift", "/wrk2-api/user/login",
               _s("user-service", "/Login", *children))
        ]

    def generate(self, api: str, rng: np.random.Generator) -> list[Span]:
        return getattr(self, api)(rng)


API_ENDPOINTS = (
    "compose_post",
    "read_home_timeline",
    "read_user_timeline",
    "register",
    "follow",
    "login",
)
