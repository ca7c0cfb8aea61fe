// Service worker: cache-first offline shell for the thin client.
// Analog of the reference's PWA worker (assets/sw.js — cache-first caching
// of the app shell); the live WebSocket stream is of course online-only.
const CACHE = "psim-tpu-v1";
const ASSETS = ["/", "/manifest.json"];

self.addEventListener("install", (e) => {
  e.waitUntil(caches.open(CACHE).then((c) => c.addAll(ASSETS)));
});

self.addEventListener("activate", (e) => {
  e.waitUntil(
    caches.keys().then((keys) =>
      Promise.all(keys.filter((k) => k !== CACHE).map((k) => caches.delete(k)))
    )
  );
});

self.addEventListener("fetch", (e) => {
  if (e.request.url.includes("/ws")) return; // never intercept the stream
  e.respondWith(
    caches.match(e.request).then((hit) => hit || fetch(e.request))
  );
});
